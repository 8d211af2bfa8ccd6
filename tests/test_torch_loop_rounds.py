"""Port parity: the ICP-verified loop closing of ``laser_slam_tpu_torch``
(``slam_offline(use_correlative=False)``: ``_loop_round``, the scan
``submap_bboxes``, ``verify_loops``, ``verify_loops_submap``,
``consistency_prune``) and the ``verify_loops_correlative`` wrapper,
against ``laser_slam_tpu``.

300 scans of the synthetic floor plan (numpy seed): the robot passes the
first doorway, turns in the room behind it and comes back through it.
JAX's front end runs once and its scans and odometry poses are carried
across; candidate pairs come from JAX's gates at the first round's
radius. End to end, the port's ``slam_offline`` runs with JAX's PSM
matcher injected into its odometry (as in ``test_torch_online.py``), so
that both packages' rounds start from the same chain up to float
round-off.
"""

import dataclasses
import inspect
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.core import se2 as jse2
from laser_slam_tpu.graph import loop_closure as jlc
from laser_slam_tpu.graph import submap as jsub
from laser_slam_tpu.ops import odometry as jodo
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu.runtime import slam as jslam
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.eval import metrics as tmetrics
from laser_slam_tpu_torch.graph import loop_closure as tlc
from laser_slam_tpu_torch.graph import submap as tsub
from laser_slam_tpu_torch.ops import odometry as todo
from laser_slam_tpu_torch.runtime import slam as tslam

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402
from test_torch_online import jax_psm  # noqa: E402  (JAX's matcher, the port's interface)

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
N_SCANS = 300
RADIUS = 2.0          # [m] the first round's search radius and ICP gate
BOX_ATOL = 1e-4       # [m] bounding boxes (float32 cos/sin of ~10 m points)
REL_ATOL = 1e-3       # [m, rad] an accepted loop's relative pose
QUALITY_ATOL = 0.02   # goodness: one matched point of 50 either way
POSE_ATOL = 2e-2      # [m, rad] poses after robust solves
SUBMAP_POINTS = 384
T = lambda x: torch.tensor(np.asarray(x))      # noqa: E731  (a copy, as a tensor)


@pytest.fixture(scope="module")
def log():
    ranges, gt, ts = synthetic_log.synthetic_log(n_scans=N_SCANS, n_whips=0)
    ranges = np.concatenate([ranges, np.full((N_SCANS, 1), MODEL.max_range + 1.0, np.float32)], 1)
    return ranges, gt.astype(np.float32), ts


@pytest.fixture(scope="module")
def front(log):
    """JAX's scans and keyframe odometry, its anchors, the submaps at
    ``SUBMAP_POINTS`` and the first round's candidates, as numpy."""
    ranges, _, ts = log
    js = jpp.preprocess(jnp.asarray(ranges), MODEL)
    poses = jodo.odometry_keyframe(MODEL, js, timestamps=ts).poses
    aidx = jnp.arange(0, N_SCANS, 10)
    sc = jscan.Scan(*(x[aidx] for x in js))
    ap = poses[aidx]
    lo, hi = jlc.submap_bboxes(MODEL, sc, ap)
    cand = jlc.select_candidates(jlc.gate_matrix(ap[:, :2], lo, hi, radius=RADIUS), ap[:, :2], 64)
    sm = jsub.build_submaps(MODEL, js, poses, 10, SUBMAP_POINTS)
    np_ = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}      # noqa: E731
    return dict(scans=tuple(np.asarray(x) for x in js), poses=np.asarray(poses),
                anchor_scans=tuple(np.asarray(x) for x in sc), anchor_poses=np.asarray(ap),
                cand=np_(cand), submaps=np_(sm))


def jax_state(f):
    return (jscan.Scan(*(jnp.asarray(x) for x in f["anchor_scans"])), jnp.asarray(f["anchor_poses"]),
            jlc.LoopCandidates(*(jnp.asarray(f["cand"][k]) for k in ("src", "dst", "valid"))),
            jsub.Submaps(*(jnp.asarray(f["submaps"][k]) for k in ("points", "valid", "anchor_idx"))))


def port_state(f):
    return (interop.scan_from_numpy(*f["anchor_scans"]), T(f["anchor_poses"]),
            interop.state_from_numpy(tlc.LoopCandidates, f["cand"]),
            interop.state_from_numpy(tsub.Submaps, f["submaps"]))


def test_bounding_boxes_match_jax(front):
    """The scan form (valid beam endpoints) and the submap form."""
    jsc, jap, _, jsm = jax_state(front)
    tsc, tap, _, tsm = port_state(front)
    for got, want in ((tlc.submap_bboxes(TMODEL, tsc, tap), jlc.submap_bboxes(MODEL, jsc, jap)),
                      (tsub.submap_bboxes(tsm, tap), jsub.submap_bboxes(jsm, jap))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=BOX_ATOL)
    lo, hi = got
    assert lo.shape == (30, 2) and bool((hi > lo).all())


def held(got, want):
    """Holds verified loops to JAX's: the same accepted set, their
    relative poses and every candidate's quality."""
    acc = np.asarray(want.accept)
    np.testing.assert_array_equal(got.accept.numpy(), acc)
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(want.src))
    np.testing.assert_allclose(got.rel.numpy(), np.asarray(want.rel), atol=REL_ATOL)
    np.testing.assert_allclose(got.quality.numpy(), np.asarray(want.quality), atol=QUALITY_ATOL)
    return acc


def test_verify_loops_and_consistency_prune_match_jax(front):
    jsc, jap, jcand, _ = jax_state(front)
    tsc, tap, tcand, _ = port_state(front)
    want = jlc.verify_loops(MODEL, jsc, jap, jcand, max_corr=RADIUS)
    got = tlc.verify_loops(TMODEL, tsc, tap, tcand, max_corr=RADIUS)
    acc = held(got, want)
    assert 10 <= acc.sum() < tcand.valid.sum()
    # The prune on JAX's loops carried across (quality included), as they
    # are and with three accepted loops bent by meters: they lose their votes.
    fields = {k: np.asarray(v) for k, v in want._asdict().items() if v is not None}
    bent = dict(fields, rel=fields["rel"].copy())
    bent["rel"][np.nonzero(acc)[0][:3], :2] += 3.0
    for f in (fields, bent):
        jl = jlc.VerifiedLoops(**{k: jnp.asarray(v) for k, v in f.items()})
        tl = interop.state_from_numpy(tlc.VerifiedLoops, f)
        assert tl.quality.dtype == torch.float32
        np.testing.assert_array_equal(tlc.consistency_prune(tl, tap).numpy(),
                                      np.asarray(jlc.consistency_prune(jl, jap)))
    keep = tlc.consistency_prune(tl, tap).numpy()
    assert keep.sum() == acc.sum() - 3 and not keep[np.nonzero(acc)[0][:3]].any()


def test_verify_loops_submap_matches_jax(front):
    _, jap, jcand, jsm = jax_state(front)
    _, tap, tcand, tsm = port_state(front)
    want = jsub.verify_loops_submap(jsm, jap, jcand, max_corr=RADIUS)
    got = tsub.verify_loops_submap(tsm, tap, tcand, max_corr=RADIUS)
    assert held(got, want).sum() >= 5


def test_verify_loops_correlative_matches_jax(front):
    """The wrapper gathers each pair's narrow and wide clouds; the
    verifier behind it is held in ``test_torch_loop_closure.py``. Small
    options: 16 candidates in chunks of 8, 24 rotations, 4 peaks."""
    _, jap, jcand, jsm = jax_state(front)
    _, tap, tcand, tsm = port_state(front)
    jw = jsub.wide_clouds(jsm, jap, max_points=512)
    tw = tuple(T(x) for x in jw)
    sel = slice(0, 16)
    jc = jlc.LoopCandidates(*(x[sel] for x in jcand))
    tc = tlc.LoopCandidates(*(x[sel] for x in tcand))
    opts = dict(search_xy=3.0, n_theta=24, n_peaks=4, chunk=8, identity_init=True)
    radius = np.float32(np.linspace(2.0, 6.0, 16))
    want = jlc.verify_loops_correlative(jsm, jap, jc, jnp.asarray(radius), *jw, **opts)
    got = tlc.verify_loops_correlative(tsm, tap, tc, T(radius), *tw, **opts)
    held(got, want)
    np.testing.assert_array_equal(got.tentative.numpy(), np.asarray(want.tentative))
    assert (got.accept | got.tentative).sum() >= 4
    # Without wide clouds the narrow ones stand in.
    want = jlc.verify_loops_correlative(jsm, jap, jc, None, **opts)
    got = tlc.verify_loops_correlative(tsm, tap, tc, None, **opts)
    held(got, want)


def test_verify_loops_correlative_takes_the_reference_options(front):
    """The wrapper names the reference's 16 options with its defaults: a
    call that passes ``coarse_chunk`` (accepted and unused in both
    packages) gives JAX's flags; an option the reference does not name is
    refused."""
    _, jap, jcand, jsm = jax_state(front)
    _, tap, tcand, tsm = port_state(front)
    sel = slice(16, 32)
    jc = jlc.LoopCandidates(*(x[sel] for x in jcand))
    tc = tlc.LoopCandidates(*(x[sel] for x in tcand))
    opts = dict(search_xy=3.0, n_theta=24, n_peaks=4, chunk=8, coarse_chunk=16,
                identity_init=True)
    want = jlc.verify_loops_correlative(jsm, jap, jc, None, **opts)
    got = tlc.verify_loops_correlative(tsm, tap, tc, None, **opts)
    held(got, want)
    np.testing.assert_array_equal(got.tentative.numpy(), np.asarray(want.tentative))
    names = lambda f: list(inspect.signature(f).parameters)[6:]          # noqa: E731
    assert names(tlc.verify_loops_correlative) == names(jlc.verify_loops_correlative)
    assert len(names(tlc.verify_loops_correlative)) == 16
    for k in names(jlc.verify_loops_correlative):
        assert (inspect.signature(tlc.verify_loops_correlative).parameters[k].default
                == pytest.approx(inspect.signature(jlc.verify_loops_correlative).parameters[k].default))
    with pytest.raises(TypeError):
        tlc.verify_loops_correlative(tsm, tap, tc, None, triage_steps_per_nn=2)


@pytest.mark.parametrize("use_submaps", [False, True])
def test_loop_round_matches_jax(front, use_submaps):
    """One gate → verify → prune → solve round from JAX's odometry."""
    jsc, jap, _, jsm = jax_state(front)
    tsc, tap, _, tsm = port_state(front)
    jcfg = jslam.SlamConfig(use_correlative=False, use_submaps=use_submaps, max_loops=64,
                            submap_points=SUBMAP_POINTS)
    tcfg = interop.config_from_fields(dataclasses.asdict(jcfg))
    rel_seq = np.asarray(jse2.relative(jap[:-1], jap[1:]))
    w = np.ones(29, np.float32)
    w[7] = 0.25
    want = jslam._loop_round(MODEL, jcfg, jsc, jap, jnp.asarray(rel_seq), jnp.float32(RADIUS),
                             jnp.asarray(w), jsm if use_submaps else None)
    got = tslam._loop_round(TMODEL, tcfg, tsc, tap, T(rel_seq), RADIUS, T(w),
                            tsm if use_submaps else None)
    assert int(got[1]) == int(want[1]) >= 5
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=POSE_ATOL)
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=5e-2, atol=1e-4)


@pytest.mark.parametrize("use_submaps", [False, True])
def test_slam_offline_icp_branch_matches_jax(log, use_submaps, monkeypatch):
    """``slam_offline(use_correlative=False)`` end to end, three rounds
    (radius 2, 4, 8 m): the same loops kept in the last round, the
    trajectory within 2e-2, the loop closures bring it nearer the ground
    truth than the odometry on the scan branch."""
    ranges, gt, ts = log
    jcfg = jslam.SlamConfig(use_correlative=False, use_submaps=use_submaps, rounds=3,
                            max_loops=64, submap_points=SUBMAP_POINTS)
    want = jslam.slam_offline(MODEL, jnp.asarray(ranges), jcfg, timestamps=ts)
    monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
    diag = {}
    got = tslam.slam_offline(TMODEL, ranges, interop.config_from_fields(dataclasses.asdict(jcfg)),
                             diag=diag, timestamps=ts, device="cpu")
    np.testing.assert_allclose(got.odo_poses.numpy(), np.asarray(want.odo_poses), atol=1e-3)
    assert int(got.n_loops) == int(want.n_loops) >= 2
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), atol=POSE_ATOL)
    np.testing.assert_allclose(float(got.chi2), float(want.chi2), rtol=5e-2, atol=1e-4)
    assert len(diag["timing"]["rounds"]) == 3 and "bank" not in diag
    assert ("submaps" in diag["timing"]) == use_submaps
    if not use_submaps:
        ate = lambda p: float(tmetrics.ate(p, torch.from_numpy(gt)).rmse)     # noqa: E731
        assert ate(got.poses) < ate(got.odo_poses)
