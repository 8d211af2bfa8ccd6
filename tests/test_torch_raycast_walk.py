"""The beam model's CUDA ray march (``csrc/raycast_kernel.cu``), held on
the CPU through a numpy transcription of its walk: 32 samples a step
(one warp a ray), the first occupied lane of a step (``__ballot_sync``,
``__ffs``), and the stop once a step lies wholly off the map and its last
sample is leaving it. The transcription is held bit for bit to the dense ladder
(``raycast._simulate_scan_ladder``, what CPU tensors run) on a room map
with the edge cases: poses off the map, rays leaving it, rays through
unknown cells, a shorter range, other thresholds, pose shapes ``[3]``,
``[P, 3]`` and ``[A, B, 3]``, and ``update_beam``'s log-weights, all
beams invalid among them. Then ``update_beam``'s chunk choice on each
path, and the kernel's wrapper refusing what it does not take.

The CPU ladder divides by the resolution where the card's multiplies by
its float32 reciprocal (as the kernel does); the transcription takes
either, and is held to the CPU ladder with the division and to a numpy
ladder with the reciprocal.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from laser_slam_tpu_torch.core.scan import LMS211
from laser_slam_tpu_torch.localization import particle_filter as pf
from laser_slam_tpu_torch.localization import raycast
from laser_slam_tpu_torch.mapping.occupancy import (
    GridSpec2D,
    OccupancyGrid,
    empty_grid,
    integrate_scans,
)
from laser_slam_tpu_torch.ops.cuda import raycast_kernel
from laser_slam_tpu_torch.ops.preprocess import preprocess
from laser_slam_tpu_torch.utils.profiling import profiler

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

torch.set_num_threads(1)

F = np.float32
# A room-sized sensor keeps the ladder short: 10 m at 5 cm is 200 samples.
ROOM_MODEL = dataclasses.replace(LMS211, max_range=10.0)
# The map covers x in [-3.5, 3], y in [-3, 3] of the 8 x 8 m room
# (x in [-3, 5], y in [-4, 4]): the left wall, the pillar and the
# L-shaped block lie on it, the other three walls off it, so most rays
# leave it.
SPEC = GridSpec2D(-3.5, -3.0, 0.05, 130, 120)
ROOM_POSES = np.asarray([(-1.0 + 0.15 * i, 1.0 - 0.05 * i, -1.0 + 0.3 * i) for i in range(10)],
                        np.float32)


def cell_of(v, origin, res, divide):
    """``floor((v - origin) / res)`` as the CPU ladder computes it
    (``divide``), or as the card computes it: ``(v - origin)`` times the
    float32 reciprocal; then the kernel's rounding-down conversion to a
    saturating int32."""
    d = v - F(origin)
    g = d / F(res) if divide else d * (F(1.0) / F(res))
    return np.clip(np.floor(g), -2.0 ** 31, 2.0 ** 31 - 1).astype(np.int64)


def walk(occupied, pose, cos_a, sin_a, spec, n_samples, max_range, divide):
    """numpy transcription of ``ray_march_kernel``: ranges ``[R, N]`` and
    the steps of 32 samples each ray took. Every ray is a warp; the rays
    still walking take their next step together."""
    h, w = occupied.shape
    flat = occupied.reshape(-1)
    r, n = cos_a.shape
    px, py = np.repeat(pose[:, 0], n), np.repeat(pose[:, 1], n)
    c, s = cos_a.reshape(-1), sin_a.reshape(-1)
    res = F(spec.resolution)
    out = np.full(r * n, F(max_range), F)
    steps = np.zeros(r * n, np.int64)
    walking = np.ones(r * n, bool)
    lane = np.arange(32)
    for base in range(0, n_samples, 32):
        at = np.flatnonzero(walking)
        if at.size == 0:
            break
        steps[at] += 1
        rs = (base + lane + 1).astype(F) * res                       # [32]
        x = px[at, None] + rs * c[at, None]                          # [A, 32]
        y = py[at, None] + rs * s[at, None]
        ix = cell_of(x, spec.origin_x, spec.resolution, divide)
        iy = cell_of(y, spec.origin_y, spec.resolution, divide)
        on_map = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h) & (base + lane < n_samples)
        occ = on_map & flat[np.where(on_map, iy * w + ix, 0)]
        hit = occ.any(axis=1)
        first = occ.argmax(axis=1)                                   # __ffs(ballot) - 1
        out[at[hit]] = (base + first[hit] + 1).astype(F) * res
        lx, ly, ca, sa = ix[:, 31], iy[:, 31], c[at], s[at]
        leaving = (((lx < 0) & (ca <= 0)) | ((lx >= w) & (ca >= 0))
                   | ((ly < 0) & (sa <= 0)) | ((ly >= h) & (sa >= 0)))
        walking[at[hit | (~on_map.any(axis=1) & leaving)]] = False
    return out.reshape(r, n), steps.reshape(r, n)


def simulate_by_walk(grid, model, pose, max_range=None, occ_threshold=0.5, divide=True,
                     steps=None):
    """``simulate_scan``'s CUDA branch on the CPU with :func:`walk` in
    the kernel's place: the same angles, map test and shapes."""
    spec = grid.spec
    if max_range is None:
        max_range = model.max_range
    n_samples = int(max_range / spec.resolution)
    ang = pose[..., 2:3] + model.bearings(pose.dtype, pose.device)
    occupied = (grid.probability > occ_threshold).numpy()
    n = model.n_beams
    out, took = walk(occupied, pose.reshape(-1, 3).numpy(), torch.cos(ang).reshape(-1, n).numpy(),
                     torch.sin(ang).reshape(-1, n).numpy(), spec, n_samples, max_range, divide)
    if steps is not None:
        steps.append(took.reshape(ang.shape))
    return torch.from_numpy(out).reshape(ang.shape)


def ladder_reciprocal(grid, model, pose, max_range, occ_threshold):
    """The dense ladder in numpy with the card's cell arithmetic."""
    spec = grid.spec
    n_samples = int(max_range / spec.resolution)
    ang = pose[..., 2:3] + model.bearings(pose.dtype, pose.device)
    c, s = torch.cos(ang).numpy()[..., None], torch.sin(ang).numpy()[..., None]
    p = pose.numpy()
    rs = (np.arange(n_samples) + 1).astype(F) * F(spec.resolution)
    x, y = p[..., 0:1, None] + rs * c, p[..., 1:2, None] + rs * s
    ix = cell_of(x, spec.origin_x, spec.resolution, False)
    iy = cell_of(y, spec.origin_y, spec.resolution, False)
    inb = (ix >= 0) & (ix < spec.width) & (iy >= 0) & (iy < spec.height)
    occupied = (grid.probability > occ_threshold).numpy().reshape(-1)
    occ = inb & occupied[np.where(inb, iy * spec.width + ix, 0)]
    r_hit = (occ.argmax(-1) + 1).astype(F) * F(spec.resolution)
    return np.where(occ.any(-1), r_hit, F(max_range))


@pytest.fixture(scope="module")
def room():
    """The room's scans at ``ROOM_POSES``, integrated into the map of
    ``SPEC``, with a band of cells reset to unknown (log-odds 0)."""
    rng = np.random.default_rng(0)
    bearings = np.asarray(ROOM_MODEL.bearings(torch.float64), np.float64)
    r = synthetic_log.ray_cast(synthetic_log.room_walls(), ROOM_POSES.astype(np.float64),
                               bearings, ROOM_MODEL.max_range)
    r = np.where(r <= ROOM_MODEL.max_range, r + rng.normal(0, 0.01, r.shape), r).astype(F)
    scans = preprocess(torch.as_tensor(r), ROOM_MODEL)
    grid = integrate_scans(empty_grid(SPEC), ROOM_MODEL, scans, torch.as_tensor(ROOM_POSES))
    log_odds = grid.log_odds.clone()
    log_odds[90:100, :] = 0.0                    # y in [1.5, 2.0): unknown
    grid = OccupancyGrid(log_odds, SPEC)
    assert int((grid.probability > 0.5).sum()) > 100
    return grid, scans


def cloud(seed=0, n=16, spread=(0.02, 0.02, 0.01)):
    """A cm-spread cloud around a room pose, and poses off the map: left
    of it facing away and facing it, far away, on its corner, and right
    of it, above it and below it, each facing it."""
    rng = np.random.default_rng(seed)
    near = ROOM_POSES[2] + rng.normal(0.0, 1.0, (n, 3)) * np.asarray(spread)
    off = [(3.6, 0.5, np.pi), (0.0, 3.4, -1.5), (0.5, -3.3, 1.7),
           (-4.0, 0.0, np.pi), (-4.0, 0.0, 0.0), (-4.0, -1.0, 0.3), (100.0, 100.0, 0.3),
           (-3.5, -3.0, 0.7), (3.5, 0.0, 0.05)]
    return torch.as_tensor(np.concatenate([near, np.asarray(off)]).astype(F))


@pytest.mark.parametrize("max_range,occ_threshold", [(None, 0.5), (3.0, 0.5), (None, 0.7),
                                                     (None, 0.3), (2.0, 0.3)])
def test_walk_is_the_ladder(room, max_range, occ_threshold):
    grid, _ = room
    poses = cloud()
    steps = []
    got = simulate_by_walk(grid, ROOM_MODEL, poses, max_range, occ_threshold, steps=steps)
    want = raycast.simulate_scan(grid, ROOM_MODEL, poses, max_range, occ_threshold)
    assert torch.equal(got, want)
    m = ROOM_MODEL.max_range if max_range is None else max_range
    hits = want < m
    assert hits.any() and not hits.all()
    # The card's arithmetic: the same walk against the same ladder.
    recip = simulate_by_walk(grid, ROOM_MODEL, poses, max_range, occ_threshold, divide=False)
    np.testing.assert_array_equal(
        recip.numpy(), ladder_reciprocal(grid, ROOM_MODEL, poses, m, occ_threshold))
    # A ray stops at the step that holds its hit.
    took = steps[0]
    first = np.round(want.numpy() / SPEC.resolution).astype(np.int64) - 1
    np.testing.assert_array_equal(took[hits.numpy()], first[hits.numpy()] // 32 + 1)


def test_walk_stops_off_the_map_once_leaving(room):
    grid, _ = room
    poses = cloud()
    steps = []
    got = simulate_by_walk(grid, ROOM_MODEL, poses, steps=steps)
    assert torch.equal(got, raycast.simulate_scan(grid, ROOM_MODEL, poses))
    took = steps[0]
    full = -(-int(ROOM_MODEL.max_range / SPEC.resolution) // 32)
    # Left of the map facing away (but for the two beams along its edge,
    # whose cosines round to either side of 0), and far from it: one step
    # a ray.
    assert (took[-6] == 1).sum() >= ROOM_MODEL.n_beams - 2 and (took[-3] == 1).all()
    # Facing the map from each side: the rays within 57 degrees of the
    # pose's heading walk on into it, to a hit or past their first step.
    ahead = np.abs(ROOM_MODEL.bearings(torch.float64).numpy()) < 1.0
    for i in (-9, -8, -7, -5):
        assert ((got[i].numpy() < ROOM_MODEL.max_range) | (took[i] > 1))[ahead].all()
    # Rays from inside that leave the map without a hit stop early.
    miss = (got[:16] == ROOM_MODEL.max_range).numpy()
    assert miss.sum() > 50 and (took[:16][miss] < full).all()


@pytest.mark.parametrize("shape", [(), (24,), (4, 6)])
def test_walk_takes_every_pose_shape(room, shape):
    grid, _ = room
    poses = cloud(seed=1, n=18)[: int(np.prod(shape)) or 1].reshape(*shape, 3)
    got = simulate_by_walk(grid, ROOM_MODEL, poses)
    assert got.shape == (*shape, ROOM_MODEL.n_beams)
    assert torch.equal(got, raycast.simulate_scan(grid, ROOM_MODEL, poses))


@pytest.mark.parametrize("all_invalid", [False, True])
@pytest.mark.parametrize("chunk", [None, 7])
def test_update_beam_through_the_walk_is_the_ladder(room, monkeypatch, chunk, all_invalid):
    """``update_beam`` with the walk in ``simulate_scan``'s place, as
    ``beam_likelihood`` looks it up: the same log-weights bit for bit."""
    grid, scans = room
    g = torch.Generator().manual_seed(5)
    state = pf.init_gaussian(g, torch.as_tensor(ROOM_POSES[3]), 20, sigma_xy=0.03,
                             sigma_theta=0.02)
    ranges = scans.ranges[3]
    valid = ~scans.bad[3] & (ranges < ROOM_MODEL.max_range)
    if all_invalid:
        valid = torch.zeros_like(valid)
    want = pf.update_beam(state, grid, ROOM_MODEL, ranges, valid, chunk=chunk)
    monkeypatch.setattr(raycast, "simulate_scan", simulate_by_walk)
    got = pf.update_beam(state, grid, ROOM_MODEL, ranges, valid, chunk=chunk)
    assert torch.equal(got.log_w, want.log_w) and torch.equal(got.poses, want.poses)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports being on CUDA: ``update_beam``'s card
    branch, walked on this CPU."""

    @property
    def is_cuda(self):
        return True


def test_update_beam_chunks_on_each_path(room, monkeypatch):
    """On CUDA the kernel holds a few floats a ray, so the whole cloud is
    one chunk; on the CPU as many poses as the ladder's ``N · S`` samples
    fit; an explicit ``chunk`` wins on both, and the weights do not
    depend on the chunks."""
    n, s = 361, 2500                               # the 2 cm beam-model cell's rays
    assert pf._chunk(4096, n * s * raycast.SIMULATE_BYTES_PER_SAMPLE, None) == 61

    grid, scans = room
    state = pf.init_gaussian(torch.Generator().manual_seed(1), torch.as_tensor(ROOM_POSES[3]), 12)
    on_card = pf.ParticleState(state.poses.as_subclass(_OnCard), state.log_w)
    valid = ~scans.bad[3]
    # Five poses' ladders fill the chunk's bytes.
    monkeypatch.setattr(pf, "CHUNK_BYTES", 5 * 181 * 200 * raycast.SIMULATE_BYTES_PER_SAMPLE)
    monkeypatch.setattr(raycast, "simulate_scan", simulate_by_walk)
    profiler.reset()
    profiler.enable()
    try:
        counts, weights = {}, []
        for name, st in (("cpu", state), ("cuda", on_card)):
            for chunk in (None, 4, 12):
                before = profiler.counts().get("pf.raycast_chunks", 0)
                got = pf.update_beam(st, grid, ROOM_MODEL, scans.ranges[3], valid, chunk=chunk)
                counts[name, chunk] = profiler.counts()["pf.raycast_chunks"] - before
                weights.append(got.log_w)
    finally:
        profiler.disable()
        profiler.reset()
    assert counts == {("cpu", None): 3, ("cpu", 4): 3, ("cpu", 12): 1,
                      ("cuda", None): 1, ("cuda", 4): 3, ("cuda", 12): 1}
    assert all(torch.equal(w, weights[0]) for w in weights)


@pytest.mark.parametrize("poses,rows", [(300, 61), (300, 16), (300, 7), (300, 300), (20, 61),
                                        (122, 61)])
def test_sum_in_chunks_takes_every_chunk_in_order(poses, rows):
    """The stack of whole chunks, the rest and the one-by-one route for
    small chunks give each row its own chunk's sum (on the CPU a row's
    sum does not depend on the call, so all equal the plain sum)."""
    x = torch.rand(poses, 181, generator=torch.Generator().manual_seed(rows))
    want = torch.cat([x[i:i + rows].clone().sum(-1) for i in range(0, poses, rows)])
    got = raycast._sum_in_chunks(x, rows)
    assert torch.equal(got, want) and torch.equal(got, x.sum(-1))


def test_cpu_tensors_take_the_ladder_and_launch_nothing(room):
    grid, _ = room
    before = raycast_kernel.ray_march.launches
    profiler.reset()
    profiler.enable()
    try:
        raycast.simulate_scan(grid, ROOM_MODEL, cloud())
        counts = profiler.counts()
    finally:
        profiler.disable()
        profiler.reset()
    assert raycast_kernel.ray_march.launches == before and "raycast.march_launches" not in counts


def test_ray_march_rejects_what_it_does_not_take():
    occupied = torch.zeros(4, 5, dtype=torch.bool)
    pose = torch.zeros(2, 3)
    c = torch.ones(2, 7)
    args = (0.0, 0.0, 0.05, 100, 5.0)
    before = raycast_kernel.ray_march.launches
    for bad, why in (((occupied, pose, c, c), "one CUDA device"),
                     ((occupied, pose.double(), c.double(), c.double()), "float32"),
                     ((occupied.float(), pose, c, c), "bool"),
                     ((occupied, pose[:, :2], c, c), r"pose \[R, 3\]"),
                     ((occupied, pose, c, c[:, :3]), "cos_a and sin_a"),
                     ((occupied, pose, c.t().contiguous().t(), c), "contiguous")):
        with pytest.raises(ValueError, match=why):
            raycast_kernel.ray_march(*bad, *args)
    assert raycast_kernel.ray_march.launches == before
