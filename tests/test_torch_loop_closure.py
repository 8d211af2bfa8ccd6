"""Port parity: loop-candidate gating and selection, PCM pruning, the
correlative peak search and the chunk verifier of ``laser_slam_tpu_torch``
against ``laser_slam_tpu``. Inputs come from a numpy seed and from 400
scans of the synthetic floor plan, whose waypoint loop passes the first
doorway twice in opposite directions."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# pytest-xdist runs several workers on the CPU; one intra-op thread each
# keeps torch's thread pools from oversubscribing it.
torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.core import se2 as jse2
from laser_slam_tpu.graph import loop_closure as jlc
from laser_slam_tpu.graph import submap as jsub
from laser_slam_tpu.ops import correlative as jc
from laser_slam_tpu.ops import icp_points as jicp
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu.runtime import slam as jslam
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.graph import loop_closure as tlc
from laser_slam_tpu_torch.ops import correlative as tc
from laser_slam_tpu_torch.ops import icp_points as ticp
from laser_slam_tpu_torch.runtime import slam as tslam

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

CYCLE_ATOL = 1e-4     # chains of four float32 pose compositions
SCORE_ATOL = 1e-5     # convolution summation order
REL_ATOL = 1e-3       # [m, rad] a verified loop's relative pose
QUALITY_ATOL = 1e-3

MODEL = jscan.LMS211
T = lambda x: torch.tensor(np.asarray(x))       # noqa: E731  (a copy, as a tensor)


def anchors(seed, a=60):
    """A two-lap noisy circuit of ``a`` anchor poses: the second lap
    revisits the first, a few decimetres off."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 4 * np.pi, a, endpoint=False)
    p = np.stack([6 * np.cos(ang), 4 * np.sin(ang), ang + np.pi / 2], 1)
    p[:, :2] += rng.normal(0, 0.3, (a, 2))
    return p.astype(np.float32)


def test_drift_radius_and_gate_matrix():
    poses = anchors(0)
    want = jlc.drift_radius_matrix(60, 2.0, jnp.float32(0.15), 5.0)
    got = tlc.drift_radius_matrix(60, 2.0, 0.15, 5.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0] == 2.0 and got[0, 1] == np.float32(2.15) and got.max() == 5.0
    rng = np.random.default_rng(1)
    lo = poses[:, :2] - rng.uniform(1, 3, (60, 2)).astype(np.float32)
    hi = poses[:, :2] + rng.uniform(1, 3, (60, 2)).astype(np.float32)
    for radius, kw in (
        (2.0, {}),                                                  # scalar, bbox overlap
        (np.asarray(want), dict(min_gap=5, overlap_min=None)),      # per pair, no overlap
        (np.asarray(want), dict(min_gap=5)),                        # per pair, dilated boxes
    ):
        jg = jlc.gate_matrix(jnp.asarray(poses[:, :2]), jnp.asarray(lo), jnp.asarray(hi),
                             radius=jnp.asarray(radius), **kw)
        tg = tlc.gate_matrix(T(poses[:, :2]), T(lo), T(hi), radius=T(radius), **kw)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        assert tg.sum() > 10 and not torch.tril(tg, kw.get("min_gap", 2)).any()


@pytest.mark.parametrize("per_dst", [0, 3])
@pytest.mark.parametrize("max_pairs", [16, 400])
def test_select_candidates_with_ties(per_dst, max_pairs):
    """Anchors on an integer lattice, so that many pairs have exactly the
    same score: both packages pick the same pairs in the same order (the
    lower flat index first among equals), also where the budget is larger
    than the gated set and ``-inf`` entries fill it."""
    rng = np.random.default_rng(2)
    a = 40
    centers = rng.integers(0, 4, (a, 2)).astype(np.float32)
    gate = np.triu(rng.random((a, a)) < 0.3, 3)
    gate[:, 7] = False                                # a destination with no candidate
    radius = np.full((a, a), 2.0, np.float32)
    boost = 0.5 * (rng.random((a, a)) < 0.2).astype(np.float32)
    for kw in ({}, dict(radius=radius), dict(radius=radius, boost=boost)):
        want = jlc.select_candidates(jnp.asarray(gate), jnp.asarray(centers), max_pairs,
                                     per_dst=per_dst, **{k: jnp.asarray(v) for k, v in kw.items()})
        got = tlc.select_candidates(T(gate), T(centers), max_pairs, per_dst=per_dst,
                                    **{k: T(v) for k, v in kw.items()})
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.src.numpy(), np.asarray(want.src))
        np.testing.assert_array_equal(got.dst.numpy(), np.asarray(want.dst))
        assert got.src.dtype == torch.int64
        ok = got.valid.numpy()
        assert gate[got.src.numpy()[ok], got.dst.numpy()[ok]].all()
        assert (ok.sum() < max_pairs) == (max_pairs == 400)
        # Ties were really there.
        score = np.linalg.norm(centers[got.src.numpy()] - centers[got.dst.numpy()], axis=1)[ok]
        assert len(np.unique(score)) < ok.sum()
    back = interop.state_to_numpy(got)
    again = interop.state_from_numpy(tlc.LoopCandidates, back)
    assert back["src"].dtype == np.int32 and torch.equal(again.src, got.src)


def loops_on(poses, seed, c=48, n_bad=6):
    """``c`` loop measurements between the laps of ``poses`` with noise,
    ``n_bad`` gross outliers and some inactive rows."""
    rng = np.random.default_rng(seed)
    a = poses.shape[0]
    src = rng.integers(0, a // 2, c)
    dst = src + a // 2 + rng.integers(-2, 3, c)
    dst = np.clip(dst, 0, a - 1)
    true = poses.astype(np.float64)
    true[a // 2:, :2] = true[: a // 2, :2] + 0.2       # the laps really coincide
    rel = jse2.np_relative(true[src], true[dst]) + rng.normal(0, 0.02, (c, 3))
    rel[:n_bad, :2] += rng.uniform(3, 8, (n_bad, 2))
    accept = rng.random(c) > 0.15
    return (src.astype(np.int32), dst.astype(np.int32), rel.astype(np.float32),
            rng.uniform(0.5, 1, c).astype(np.float32), accept)


@pytest.mark.parametrize("conflict_k", [0, 4])
def test_pcm(conflict_k):
    poses = anchors(3)
    src, dst, rel, q, accept = loops_on(poses, 4)
    want = jlc.pcm_cycle_errors(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(rel),
                                jnp.asarray(poses))
    got = tlc.pcm_cycle_errors(T(src).long(), T(dst).long(), T(rel), T(poses))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=CYCLE_ATOL)
    jl = jlc.VerifiedLoops(*(jnp.asarray(x) for x in (src, dst, rel, q, accept)))
    tl = interop.state_from_numpy(tlc.VerifiedLoops, {k: None if v is None else np.asarray(v)
                                                      for k, v in jl._asdict().items()})
    jk = jlc.pcm_prune(jl, jnp.asarray(poses), conflict_k=conflict_k)
    tk = tlc.pcm_prune(tl, T(poses), conflict_k=conflict_k)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 10 < tk.sum() < accept.sum() and not tk[~T(accept)].any()
    # Nothing accepted, and a solitary loop.
    none = tl._replace(accept=torch.zeros_like(tl.accept))
    assert not tlc.pcm_prune(none, T(poses)).any()
    solo = torch.zeros_like(tl.accept)
    solo[10] = True
    np.testing.assert_array_equal(tlc.pcm_prune(tl._replace(accept=solo), T(poses)).numpy(),
                                  solo.numpy())


@pytest.fixture(scope="module")
def clouds():
    """Narrow (384) and wide (768, ±4 submaps) clouds of the 40 anchors of
    a 400-scan synthetic log, built by the JAX package from the ground-
    truth poses; and the anchor poses."""
    n = 400
    ranges, gt, _ = synthetic_log.synthetic_log(n_scans=n, n_whips=0)
    ranges = np.concatenate([ranges, np.full((n, 1), MODEL.max_range + 1.0, np.float32)], 1)
    js = jpp.preprocess(jnp.asarray(ranges), MODEL)
    poses = jse2.np_relative(gt[0], gt).astype(np.float32)
    sm = jax.jit(lambda s, p: jsub.build_submaps(MODEL, s, p, 10, 384))(js, jnp.asarray(poses))
    ap = poses[::10]
    wide = jax.jit(lambda m, p: jsub.wide_clouds(m, p, wing=4, max_points=768))(sm, jnp.asarray(ap))
    return (np.asarray(sm.points), np.asarray(sm.valid), np.asarray(wide[0]),
            np.asarray(wide[1]), ap)


# Pairs of the 400-scan log: six true revisits of the first doorway (the
# same place 130-170 scans later, five of them facing the other way), a far
# pair and an invalid one.
SRC = np.asarray([12, 11, 15, 13, 10, 16, 2, 5])
DST = np.asarray([27, 28, 24, 26, 29, 23, 30, 38])


@pytest.mark.parametrize("overlap_norm", [False, True])
def test_correlative_top_peaks(clouds, overlap_norm):
    pts, ok, wp, wo, _ = clouds
    s, d = SRC[:4], DST[:4]
    init = np.zeros((4, 3), np.float32)
    init[1] = [0.2, -0.1, 0.3]
    kw = dict(n_peaks=6, search_xy=3.0, n_theta=24, res=0.3, overlap_norm=overlap_norm)
    want = jax.jit(jax.vmap(lambda a, b, c, e, p: jc.correlative_top_peaks(a, b, c, e, p, **kw)))(
        *(jnp.asarray(x) for x in (wp[s], wo[s], pts[d][:, ::2], ok[d][:, ::2], init)))
    got = tc.correlative_top_peaks(T(wp[s]), T(wo[s]), T(pts[d])[:, ::2], T(ok[d])[:, ::2],
                                   T(init), **kw)
    assert got[0].shape == (4, 6, 3)
    # Same cells of the (θ, y, x) volume, in the same order; same scores.
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=SCORE_ATOL)
    assert (got[1][:, 0] > 0.3).all() and (got[1][:, :-1] >= got[1][:, 1:]).all()


def test_top_peaks_order_on_a_plateau():
    """A reference that is one long wall: sliding along it changes nothing,
    so the score volume has plateaus and equal peaks. Both packages list
    them in the same order (the lower flat index first)."""
    x = np.linspace(-8, 8, 400, dtype=np.float32)
    ref = np.stack([x, np.full_like(x, 2.0)], 1)[None]
    cur = ref[:, 150:250]
    ok_r, ok_c = np.ones((1, 400), bool), np.ones((1, 100), bool)
    init = np.zeros((1, 3), np.float32)
    kw = dict(n_peaks=8, search_xy=1.5, n_theta=8, res=0.3)
    want = jax.vmap(lambda a, b, c, e, p: jc.correlative_top_peaks(a, b, c, e, p, **kw))(
        *(jnp.asarray(v) for v in (ref, ok_r, cur, ok_c, init)))
    got = tc.correlative_top_peaks(T(ref), T(ok_r), T(cur), T(ok_c), T(init), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=SCORE_ATOL)
    top = got[1][0].numpy()
    assert (np.abs(top - top[0]) < 1e-6).sum() >= 3          # equal peaks were there


def test_match_correlative_points(clouds):
    pts, ok, wp, wo, _ = clouds
    s, d = SRC[2:6], DST[2:6]
    init = np.zeros((4, 3), np.float32)
    kw = dict(search_xy=3.0, search_theta=np.pi, n_theta=36, res=0.3, half_extent=12.8)
    want = jax.jit(jax.vmap(lambda a, b, c, e, p: jc.match_correlative_points(a, b, c, e, p, **kw)))(
        *(jnp.asarray(x) for x in (wp[s], wo[s], pts[d], ok[d], init)))
    got = tc.match_correlative_points(T(wp[s]), T(wo[s]), T(pts[d]), T(ok[d]), T(init), **kw)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-5)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), atol=SCORE_ATOL)
    np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))


@pytest.mark.parametrize("steps_per_nn,iters", [(1, 12), (2, 12), (2, 7)])
def test_match_icp_points_strided_and_steps_per_nn(clouds, steps_per_nn, iters):
    """Strided views of the clouds (as the verifier's triage passes them)
    and correspondences reused for two pose updates; 7 updates at 2 a
    search run 8, in both packages."""
    pts, ok, wp, wo, ap = clouds
    s, d = SRC[:6], DST[:6]
    init = jse2.np_relative(ap[s], ap[d]).astype(np.float32)
    init[:, :2] += 0.15
    want = jax.jit(jax.vmap(lambda a, b, c, e, p: jicp.match_icp_points(
        a[::2], b[::2], c[::2], e[::2], p, iters=iters, max_corr=1.2,
        steps_per_nn=steps_per_nn)))(*(jnp.asarray(x) for x in (wp[s], wo[s], pts[d], ok[d], init)))
    got = ticp.match_icp_points(T(wp[s])[:, ::2], T(wo[s])[:, ::2], T(pts[d])[:, ::2],
                                T(ok[d])[:, ::2], T(init), iters=iters, max_corr=1.2,
                                steps_per_nn=steps_per_nn)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=1e-4)
    np.testing.assert_array_equal(got.n_matched.numpy(), np.asarray(want.n_matched))
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err), rtol=1e-3)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), rtol=1e-3, atol=1e-9)
    assert not got.fail.any()


def test_verify_pairs_correlative(clouds):
    """One chunk of eight candidates through the whole verifier at 48
    rotation samples: the current estimate is 0.85 m off, the search
    starts from identity. Strict and tentative tiers, the lane, every
    gate mask and the relative poses agree; three true revisits are
    accepted, three more are tentative, the far and the invalid pair are
    neither."""
    pts, ok, wp, wo, ap = clouds
    valid = np.ones(8, bool)
    valid[-1] = False
    true = jse2.np_relative(ap[SRC], ap[DST]).astype(np.float32)
    est = true.copy()
    est[:, :2] += 0.6
    trust = np.full(8, 3.0, np.float32)
    kw = dict(search_xy=5.0, n_theta=48, coarse_res=0.3, n_peaks=4, chunk=0, identity_init=True)
    args = (wp[SRC], wo[SRC], pts[SRC], ok[SRC], wp[DST], wo[DST], pts[DST], ok[DST],
            est, valid, trust)
    want = jax.jit(lambda *a: jlc.verify_pairs_correlative(*a, **kw))(*(jnp.asarray(x) for x in args))
    got = tlc.verify_pairs_correlative(*(T(x) for x in args), **kw)
    np.testing.assert_array_equal(got.accept.numpy(), np.asarray(want.accept))
    np.testing.assert_array_equal(got.tentative.numpy(), np.asarray(want.tentative))
    np.testing.assert_array_equal(got.diag["lane"].numpy(), np.asarray(want.diag["lane"]))
    for k, w in want.diag.items():
        w = np.asarray(w)
        if w.dtype == bool:
            np.testing.assert_array_equal(got.diag[k].numpy(), w, err_msg=k)
        else:
            np.testing.assert_allclose(got.diag[k].numpy(), w, atol=REL_ATOL, err_msg=k)
    np.testing.assert_allclose(got.rel.numpy(), np.asarray(want.rel), atol=REL_ATOL)
    np.testing.assert_allclose(got.quality.numpy(), np.asarray(want.quality), atol=QUALITY_ATOL)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), rtol=1e-2, atol=1e-9)
    acc, ten = got.accept.numpy(), got.tentative.numpy()
    assert acc.sum() == 3 and ten.sum() == 3 and not (acc | ten)[6:].any()
    # The accepted loops measure the true relative pose.
    d = jse2.np_relative(true[acc], got.rel.numpy()[acc])
    assert np.abs(d[:, :2]).max() < 0.1 and np.abs(d[:, 2]).max() < 0.05
    # In two sub-batches of four (the memory bound of a large batch): the same.
    halves = tlc.verify_pairs_correlative(*(T(x) for x in args), **{**kw, "chunk": 4})
    np.testing.assert_array_equal(halves.accept.numpy(), got.accept.numpy())
    np.testing.assert_allclose(halves.rel.numpy(), got.rel.numpy(), atol=1e-6)
    # The state goes across and back unchanged.
    back = interop.state_to_numpy(got)
    assert back["diag"] is None and back["src"].dtype == np.int32
    again = interop.state_from_numpy(tlc.VerifiedLoops, back)
    assert torch.equal(again.rel, got.rel) and torch.equal(again.accept, got.accept)


@pytest.mark.parametrize("focus", [False, True])
def test_propose(focus):
    """Proposal from the same poses, appearance gate, tried matrix and
    coverage: the same candidates in the same order, the same trust radii,
    the same tried matrix afterwards."""
    rng = np.random.default_rng(6)
    poses = anchors(5)
    a = poses.shape[0]
    sig_gate = np.triu(rng.random((a, a)) < 0.02, 6)
    tried = np.triu(rng.random((a, a)) < 0.1, 1)
    cov = (rng.random(a) < 0.6).astype(np.int32) * rng.integers(1, 4, a).astype(np.int32)
    jcfg = jslam.SlamConfig(max_loops=48, per_dst=4)
    tcfg = interop.config_from_fields(interop.config_to_fields(tslam.SlamConfig(max_loops=48, per_dst=4)))
    assert interop.config_to_fields(tcfg) == {k: getattr(jcfg, k) for k in interop.config_to_fields(tcfg)}
    want = jslam._propose(jcfg, jnp.asarray(poses), jnp.float32(0.05), jnp.asarray(sig_gate),
                          jnp.asarray(tried), jnp.asarray(cov), focus, jnp.float32(0.12))
    got = tslam._propose(tcfg, T(poses), 0.05, T(sig_gate), T(tried), T(cov), focus, 0.12)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    n_new = int(got[2].sum() - tried.sum())
    assert n_new == int(got[0].valid.sum()) > 10
    if focus:
        s, d = got[0].src[got[0].valid], got[0].dst[got[0].valid]
        assert ((T(cov)[s] == 0) | (T(cov)[d] == 0)).all()
