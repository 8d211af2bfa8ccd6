"""Port parity: submaps, wide clouds and the signature gate of
``laser_slam_tpu_torch`` against ``laser_slam_tpu`` on 240 scans of the
synthetic floor plan (numpy seed), with the ground-truth poses plus a
smooth drift standing in for odometry."""

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
from laser_slam_tpu.graph import place_recognition as jpr
from laser_slam_tpu.graph import submap as jsub
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.graph import place_recognition as tpr
from laser_slam_tpu_torch.graph import submap as tsub

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

POINT_ATOL = 1e-5     # [m] float32 rigid transform of a point ≤ 50 m away
SIG_ATOL = 1e-5
# A point within a float32 last bit of a voxel edge can fall into the
# neighbouring voxel in one package (XLA's and PyTorch's cos/sin differ in
# the last bit; a beam at ±90° has x = ±1e-7 m, on the edge at 0). It then
# opens or closes a voxel, another point of that voxel survives, and the
# compacted rows behind it shift by one, so clouds are compared as sets.
# At most this share of the points may lack a partner within POINT_ATOL.
EDGE_POINTS = 0.005

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
STRIDE = 10


@pytest.fixture(scope="module")
def log():
    """``(jax scans, port scans, poses [T, 3])``."""
    ranges, gt, _ = synthetic_log.synthetic_log(n_scans=240, n_whips=0)
    ranges = np.concatenate([ranges, np.full((240, 1), MODEL.max_range + 1.0, np.float32)], 1)
    js = jpp.preprocess(jnp.asarray(ranges), MODEL)
    ts = interop.scan_from_numpy(*(np.asarray(x) for x in js))
    t = np.arange(240)[:, None]
    poses = (gt - gt[0] + np.concatenate([0.002 * t, -0.001 * t, 0.0005 * t], 1)).astype(np.float32)
    return js, ts, poses


def unmatched(got_pts, got_ok, want_pts, want_ok):
    """``(points without a partner within POINT_ATOL in the other cloud,
    both ways, summed over the clouds [S, P]; valid points in all)``."""
    n = 0
    for gp, go, wp, wo in zip(got_pts, got_ok, want_pts, want_ok):
        g, w = gp[go], wp[wo]
        d = np.abs(g[:, None, :] - w[None, :, :]).max(-1) <= POINT_ATOL
        n += int((~d.any(1)).sum() + (~d.any(0)).sum())
    return n, int(want_ok.sum())


def test_reduce_group_keeps_the_first_point_of_a_voxel():
    """Hand-made groups: several points in one voxel (the first in scan,
    then beam order survives: both sorts are stable), masked points, a
    budget smaller and larger than the voxel count."""
    rng = np.random.default_rng(11)
    k, n = 3, 40
    cells = rng.integers(-6, 6, (2, k, n, 2))
    pts = ((cells + rng.uniform(0.1, 0.9, cells.shape)) * 0.05).astype(np.float32)
    valid = rng.random((2, k, n)) > 0.2
    rel = np.zeros((2, k, 3), np.float32)           # identity: voxels stay exact
    for budget in (16, 120):
        want = jax.vmap(lambda p, v, r: jsub.reduce_group(p, v, r, budget))(
            jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(rel))
        got = tsub.reduce_group(torch.from_numpy(pts), torch.from_numpy(valid),
                                torch.from_numpy(rel), budget)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    # First occurrence: the survivor of each voxel is its first valid point.
    flat_p, flat_v = pts[0].reshape(-1, 2), valid[0].reshape(-1)
    key = [tuple(c) for c in np.floor(flat_p / np.float32(0.05)).astype(int)]
    firsts = {}
    for i, c in enumerate(key):
        if flat_v[i]:
            firsts.setdefault(c, flat_p[i])
    out = got[0][0].numpy()[got[1][0].numpy()]
    assert len(out) == len(firsts) <= 120
    for p in out:
        np.testing.assert_array_equal(p, firsts[tuple(np.floor(p / np.float32(0.05)).astype(int))])


def test_build_submaps_and_bboxes(log):
    js, ts, poses = log
    want = jax.jit(lambda s, p: jsub.build_submaps(MODEL, s, p, STRIDE, 256))(js, jnp.asarray(poses))
    got = tsub.build_submaps(TMODEL, ts, torch.from_numpy(poses), STRIDE, 256)
    assert got.points.shape == (24, 256, 2) and got.valid.shape == (24, 256)
    np.testing.assert_array_equal(got.anchor_idx.numpy(), np.asarray(want.anchor_idx))
    off, total = unmatched(got.points.numpy(), got.valid.numpy(),
                           np.asarray(want.points), np.asarray(want.valid))
    assert off <= EDGE_POINTS * total and total > 24 * 200, (off, total)
    # The masks are those of front-compacted clouds of (nearly) equal counts.
    counts = got.valid.sum(1).numpy()
    assert np.abs(counts - np.asarray(want.valid).sum(1)).max() <= 2
    assert all(got.valid[i, :c].all() and not got.valid[i, c:].any() for i, c in enumerate(counts))
    # From JAX's submaps on: boxes under moved anchor poses.
    tsm = interop.state_from_numpy(tsub.Submaps, {k: np.asarray(v) for k, v in want._asdict().items()})
    anchors = poses[::STRIDE] + np.asarray([0.3, -0.2, 0.1], np.float32)
    lo, hi = tsub.submap_bboxes(tsm, torch.from_numpy(anchors))
    jlo, jhi = jsub.submap_bboxes(want, jnp.asarray(anchors))
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), atol=POINT_ATOL)
    np.testing.assert_allclose(hi.numpy(), np.asarray(jhi), atol=POINT_ATOL)
    back = interop.state_to_numpy(tsm)
    assert back["anchor_idx"].dtype == np.int32
    np.testing.assert_array_equal(back["points"], np.asarray(want.points))


@pytest.mark.parametrize("blocks", [False, True])
def test_wide_clouds(log, blocks):
    """From JAX's submaps: ±2 submaps merged at 10 cm, with and without a
    fracture between anchors 9 and 10."""
    js, _, poses = log
    jsm = jax.jit(lambda s, p: jsub.build_submaps(MODEL, s, p, STRIDE, 256))(js, jnp.asarray(poses))
    tsm = interop.state_from_numpy(tsub.Submaps, {k: np.asarray(v) for k, v in jsm._asdict().items()})
    anchors = poses[::STRIDE]
    bid = (np.arange(24) >= 10).astype(np.int32) if blocks else None
    want = jax.jit(lambda sm, ap, b: jsub.wide_clouds(sm, ap, wing=2, max_points=512, block_id=b))(
        jsm, jnp.asarray(anchors), None if bid is None else jnp.asarray(bid))
    got = tsub.wide_clouds(tsm, torch.from_numpy(anchors), wing=2, max_points=512,
                           block_id=None if bid is None else torch.from_numpy(bid).long())
    assert got[0].shape == (24, 512, 2)
    off, total = unmatched(got[0].numpy(), got[1].numpy(), np.asarray(want[0]), np.asarray(want[1]))
    assert off <= EDGE_POINTS * total, (off, total)
    assert np.abs(got[1].sum(1).numpy() - np.asarray(want[1]).sum(1)).max() <= 2
    # The wide cloud holds more than its own submap, and less across a fracture.
    assert (got[1].sum(1) > tsm.valid.sum(1)).all()
    if blocks:
        open_ = tsub.wide_clouds(tsm, torch.from_numpy(anchors), wing=2, max_points=512)
        assert got[1][9].sum() < open_[1][9].sum() and got[1][5].sum() == open_[1][5].sum()


def test_signatures_and_gate(log):
    js, _, poses = log
    jsm = jax.jit(lambda s, p: jsub.build_submaps(MODEL, s, p, STRIDE, 256))(js, jnp.asarray(poses))
    pts, ok = np.asarray(jsm.points), np.asarray(jsm.valid)
    want = jax.jit(lambda p, v: jpr.submap_signatures(p, v, sample=128, chunk=8))(jsm.points, jsm.valid)
    got = tpr.submap_signatures(torch.from_numpy(pts), torch.from_numpy(ok), sample=128, chunk=8)
    assert got.shape == (24, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=SIG_ATOL)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, atol=1e-5)
    # A signature does not change under a rigid motion of its cloud.
    th = 0.7
    rot = np.asarray([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]], np.float32)
    moved = tpr.submap_signatures(torch.from_numpy(pts @ rot.T + np.float32(3.0)),
                                  torch.from_numpy(ok), sample=128, chunk=8)
    np.testing.assert_allclose(moved.numpy(), got.numpy(), atol=2e-3)
    # Affinity and gate from JAX's signatures: the gate is identical.
    sig = torch.from_numpy(np.asarray(want))
    np.testing.assert_allclose(tpr.signature_affinity(sig).numpy(),
                               np.asarray(jpr.signature_affinity(want)), atol=SIG_ATOL)
    for per_dst, floor in ((6, 0.5), (3, 0.0), (40, 0.9)):
        g = tpr.signature_gate(sig, min_gap=5, per_dst=per_dst, min_affinity=floor)
        jg = jpr.signature_gate(want, min_gap=5, per_dst=per_dst, min_affinity=floor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert 0 < g.sum() and not torch.tril(g, 5).any()


def test_signature_gate_keeps_every_tie():
    """Equal affinities at the ``per_dst``-th rank: all of them pass (the
    cut is on the value), in both packages."""
    sig = np.zeros((12, 4), np.float32)
    sig[:, 0] = 1.0
    sig[3:6] = [0.5, 0.5, 0.0, 0.0]          # three identical earlier submaps
    sig[11] = [0.5, 0.4, 0.1, 0.0]
    g = tpr.signature_gate(torch.from_numpy(sig), min_gap=2, per_dst=2, min_affinity=0.0)
    jg = jpr.signature_gate(jnp.asarray(sig), min_gap=2, per_dst=2, min_affinity=0.0)
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    assert g[3:6, 11].all() and g[:, 11].sum() == 3
