"""Port parity: point-cloud ICP and the correlative matcher of
``laser_slam_tpu_torch`` against ``laser_slam_tpu``, batched over pairs
of scans ray-cast in an asymmetric room."""

import dataclasses
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
from laser_slam_tpu.ops import correlative as jc
from laser_slam_tpu.ops import icp_points as jicp
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.ops import correlative as tc
from laser_slam_tpu_torch.ops import icp_points as ticp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

ICP_POSE_ATOL = 1e-4   # float32 sums of the closed-form update, 15-40 iterations
COV_RTOL = 1e-3        # 3×3 inverse of float32 sums
VOLUME_ATOL = 1e-5     # convolution summation order
POSE_ATOL = 1e-4

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
# (x, y, θ) of cur in ref's frame; the last pair turns by 95°.
RELS = [(0.05, -0.03, 0.1), (0.25, 0.1, -0.45), (0.02, -0.01, 1.66)]


def scans(rels, seed=30):
    rng = np.random.default_rng(seed)
    p0 = np.stack([rng.uniform(-0.5, 2.0, len(rels)), rng.uniform(-1.0, 1.5, len(rels)),
                   rng.uniform(-np.pi, np.pi, len(rels))], 1)
    p1 = jse2.np_compose(p0, np.asarray(rels, np.float64))
    fi = np.asarray(MODEL.bearings(), np.float64)
    out = []
    for p in (p0, p1):
        r = synthetic_log.ray_cast(synthetic_log.room_walls(), p, fi, MODEL.max_range)
        r = np.where(r <= MODEL.max_range, r + rng.normal(0, 0.01, r.shape), r)
        js = jpp.preprocess(jnp.asarray(r.astype(np.float32)), MODEL)
        out += [js, interop.scan_from_numpy(*(np.asarray(x) for x in js))]
    return out   # jax ref, torch ref, jax cur, torch cur


@pytest.mark.parametrize("iters,max_corr", [(15, 0.3), (40, 1.0)])
def test_match_icp_points(iters, max_corr):
    jref, tref, jcur, tcur = scans(RELS[:2] + [(0.1, 0.05, 0.05)], seed=31)
    jrp, jro = jax.vmap(lambda s: jicp.scan_to_points(MODEL, s))(jref)
    jcp, jco = jax.vmap(lambda s: jicp.scan_to_points(MODEL, s))(jcur)
    trp, tro = ticp.scan_to_points(TMODEL, tref)
    tcp, tco = ticp.scan_to_points(TMODEL, tcur)
    np.testing.assert_allclose(trp.numpy(), np.asarray(jrp), atol=1e-6)
    np.testing.assert_array_equal(tro.numpy(), np.asarray(jro))
    init = np.asarray([[0.0, 0.0, 0.0], [0.2, 0.05, -0.4], [0.08, 0.03, 0.02]], np.float32)
    want = jax.jit(jax.vmap(lambda a, b, c, d, p: jicp.match_icp_points(
        a, b, c, d, p, iters=iters, max_corr=max_corr)))(jrp, jro, jcp, jco, jnp.asarray(init))
    got = ticp.match_icp_points(trp, tro, tcp, tco, torch.from_numpy(init),
                                iters=iters, max_corr=max_corr)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=ICP_POSE_ATOL)
    np.testing.assert_array_equal(got.n_matched.numpy(), np.asarray(want.n_matched))
    np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))
    np.testing.assert_allclose(got.goodness.numpy(), np.asarray(want.goodness), rtol=1e-6)
    np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err), rtol=1e-3)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov), rtol=COV_RTOL, atol=1e-9)
    assert not got.fail.any()


@pytest.mark.parametrize("overlap_norm", [False, True])
def test_correlative_score_volume(overlap_norm):
    jref, tref, jcur, tcur = scans(RELS, seed=32)
    jrp, jro = jax.vmap(lambda s: jicp.scan_to_points(MODEL, s))(jref)
    jcp, jco = jax.vmap(lambda s: jicp.scan_to_points(MODEL, s))(jcur)
    jg = jax.vmap(lambda p, o: jc.build_likelihood_grid_points(p, o))(jrp, jro)
    tg = tc.build_likelihood_grid_points(*ticp.scan_to_points(TMODEL, tref))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=VOLUME_ATOL)
    thetas = np.linspace(-np.pi, np.pi, 24, dtype=np.float32)[None].repeat(3, 0)
    thetas += np.asarray([[0.0], [0.01], [-0.02]], np.float32)
    base = np.asarray([[0.0, 0.0], [0.12, -0.07], [-0.3, 0.2]], np.float32)
    n_steps, res = 11, 0.1
    want = jax.jit(jax.vmap(lambda g, p, o, t, b: jc.correlative_score_volume(
        g, p, o, t, n_steps, res, jc.GRID_HALF_EXTENT, b, overlap_norm=overlap_norm)))(
        jg, jcp, jco, jnp.asarray(thetas), jnp.asarray(base))
    tcp, tco = ticp.scan_to_points(TMODEL, tcur)
    got = tc.correlative_score_volume(
        torch.from_numpy(np.array(jg)), tcp, tco, torch.from_numpy(thetas), n_steps, res,
        tc.GRID_HALF_EXTENT, torch.from_numpy(base), overlap_norm=overlap_norm)
    assert got.shape == (3, 24, 2 * n_steps + 1, 2 * n_steps + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VOLUME_ATOL)
    assert got.max() > 0.3


def test_match_correlative():
    """Three pairs, one turned by 95°: the same peak cell and, after the
    ICP polish, the same pose as the JAX matcher. (The room is square, so
    from some poses a 95° turn aliases to a near-zero one in both
    packages; the seed's pairs are unambiguous.)"""
    jref, tref, jcur, tcur = scans(RELS, seed=37)
    for refine in (False, True):
        want = jax.jit(jax.vmap(lambda a, b: jc.match_correlative(
            MODEL, a, b, search_xy=1.2, n_theta=72, refine=refine)))(jref, jcur)
        got = tc.match_correlative(TMODEL, tref, tcur, search_xy=1.2, n_theta=72,
                                   refine=refine)
        if not refine:
            # The peak cell of the (θ, x, y) search grid.
            def cell(pose):
                return np.round(np.stack([(pose[:, 2] + np.pi) / (2 * np.pi / 71),
                                          pose[:, 0] / 0.1, pose[:, 1] / 0.1], 1))
            np.testing.assert_array_equal(cell(got.pose.numpy()), cell(np.asarray(want.pose)))
        np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=POSE_ATOL)
        np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), atol=VOLUME_ATOL)
        np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))
    # The polished poses recover the true motion, the 95° turn included.
    d = got.pose.numpy() - np.asarray(RELS)
    assert np.abs(d[:, :2]).max() < 0.05 and np.abs(d[:, 2]).max() < 0.02


def test_score_theta_gather_path_matches_jax():
    """The gather path's score grid for one rotation against JAX's, with a
    point beyond the grid's edge that a shift brings back in: the gather
    path credits it at that shift, the convolution path drops it."""
    jref, tref, jcur, tcur = scans(RELS[:2], seed=38)
    he, res = tc.GRID_HALF_EXTENT, tc.GRID_RES
    # Pair 0's reference gets a point in the grid's last column; its
    # current scan a point half a cell past the edge, on the same row.
    ref_pts, ref_ok = tc.scan_to_points(TMODEL, tref)
    pts, ok = tc.scan_to_points(TMODEL, tcur)
    ref_pts, ref_ok, pts, ok = (x.clone() for x in (ref_pts, ref_ok, pts, ok))
    ref_pts[0, 0] = torch.tensor([he - 0.05, 1.05])
    pts[0, 0] = torch.tensor([he + 0.05, 1.05])
    ref_ok[0, 0] = ok[0, 0] = True
    grid = tc.build_likelihood_grid_points(ref_pts, ref_ok)
    jgrid = jax.vmap(jc.build_likelihood_grid_points)(jnp.asarray(ref_pts.numpy()),
                                                      jnp.asarray(ref_ok.numpy()))
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), atol=VOLUME_ATOL)
    theta = torch.tensor([0.0, 0.3])
    steps = torch.arange(-3, 4, dtype=torch.float32) * res
    base = torch.tensor([[0.0, 0.0], [0.1, -0.2]])
    got = tc._score_theta(grid, res, he, pts, ok, theta, steps, base)
    jsteps = jnp.asarray(steps.numpy())
    want = jax.vmap(lambda g, p, v, t, b: jc._score_theta(g, res, he, p, v, t, jsteps, b))(
        jgrid, jnp.asarray(pts.numpy()), jnp.asarray(ok.numpy()), jnp.asarray(theta.numpy()),
        jnp.asarray(base.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=VOLUME_ATOL)
    conv = tc.correlative_score_volume(grid, pts, ok, theta[:, None], 3, res, he, base)[:, 0]
    conv = conv.transpose(1, 2)                             # [B, Tx, Ty]
    # Pair 1 has no point off the grid: both paths agree everywhere.
    np.testing.assert_allclose(got[1].numpy(), conv[1].numpy(), atol=VOLUME_ATOL)
    # Pair 0's outside point lands in the grid at the shifts x ≤ -1 cell
    # (index 0-2 of the 7), on the reference's point at x = -1 cell.
    extra = (got[0] - conv[0]) * float(ok[0].sum())
    assert float(extra[2, 3]) > 0.9
    assert float(extra[:3].min()) >= -1e-4 and float(extra[3:].abs().max()) < 1e-4


def test_match_correlative_gather_path_matches_jax():
    """``match_correlative(conv=False)`` against JAX's gather path."""
    jref, tref, jcur, tcur = scans(RELS, seed=37)
    want = jax.jit(jax.vmap(lambda a, b: jc.match_correlative(
        MODEL, a, b, search_xy=1.2, n_theta=24, conv=False)))(jref, jcur)
    got = tc.match_correlative(TMODEL, tref, tcur, search_xy=1.2, n_theta=24, conv=False)
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(want.pose), atol=POSE_ATOL)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), atol=VOLUME_ATOL)
    np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))
