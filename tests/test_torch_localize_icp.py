"""The ray-cast + ICP observation model (``particle_filter.update_raycast_icp``)
on the port's normal paths, on the CPU: the batched update against a loop
of single-particle matches and against the benchmark's plain reference
(``benchmark/reference/localize_icp.py``), what the nudge and the goodness
weights do, the weight of a failed match, the ICP's chunk rule on each
path, ``update_icp``'s results through the shared weight-and-nudge helper,
``cli localize --model icp`` and ``SlamV1``'s localization mode with
``observation_model="icp"``.

The room's sensor reaches 10 m, so the CPU's dense ladder stays short
(200 samples at 5 cm); the CLI runs on a coarse map (0.2 m cells).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from laser_slam_tpu_torch import cli as tcli
from laser_slam_tpu_torch.core import se2
from laser_slam_tpu_torch.core.scan import LMS211
from laser_slam_tpu_torch.localization import particle_filter as pf
from laser_slam_tpu_torch.localization import raycast
from laser_slam_tpu_torch.mapping.occupancy import (
    empty_grid,
    integrate_scans,
    spec_for_trajectory,
)
from laser_slam_tpu_torch.ops import icp_points
from laser_slam_tpu_torch.ops.icp_points import match_icp_points
from laser_slam_tpu_torch.ops.preprocess import preprocess
from laser_slam_tpu_torch.runtime import facade as tfacade
from laser_slam_tpu_torch.utils.profiling import profiler

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
import synthetic_log  # noqa: E402

torch.set_num_threads(1)

ROOM_MODEL = dataclasses.replace(LMS211, max_range=10.0)
POSES = np.asarray([(-1.0 + 0.15 * i, 1.0 - 0.05 * i, -1.0 + 0.3 * i) for i in range(10)],
                   np.float32)


def room_ranges(poses, seed=0):
    """Ranges ``[T, N]`` in the asymmetric room of ``tools/synthetic_log.py``."""
    rng = np.random.default_rng(seed)
    bearings = np.asarray(ROOM_MODEL.bearings(torch.float64), np.float64)
    r = synthetic_log.ray_cast(synthetic_log.room_walls(), np.asarray(poses, np.float64),
                               bearings, ROOM_MODEL.max_range)
    return np.where(r <= ROOM_MODEL.max_range, r + rng.normal(0, 0.01, r.shape),
                    r).astype(np.float32)


@pytest.fixture(scope="module")
def room():
    """The room's 5 cm map from ten poses, and a cloud of 32 particles
    around pose 2 with the scan taken there."""
    scans = preprocess(torch.as_tensor(room_ranges(POSES)), ROOM_MODEL)
    spec = spec_for_trajectory(POSES, ROOM_MODEL.max_range, 0.05)
    grid = integrate_scans(empty_grid(spec), ROOM_MODEL, scans, torch.as_tensor(POSES))
    g = torch.Generator().manual_seed(3)
    state = pf.init_gaussian(g, torch.as_tensor(POSES[2]), 32, sigma_xy=0.1, sigma_theta=0.05)
    return grid, state, scans.ranges[2], ~scans.bad[2]


def _one_by_one(grid, state, ranges, valid, nudge=True):
    """The update as a loop over particles: each one's simulated scan, its
    hits as world points, one ``match_icp_points`` call of a single pair."""
    m = ROOM_MODEL
    fi = m.bearings()
    scan_pts = torch.stack([ranges * torch.cos(fi), ranges * torch.sin(fi)], -1)[None]
    scan_ok = (valid & (ranges < m.max_range) & (ranges > m.min_range))[None]
    liks, poses = [], []
    for pose in state.poses:
        sim = raycast.simulate_scan(grid, m, pose)
        ang = pose[2] + fi
        pts = torch.stack([pose[0] + sim * torch.cos(ang), pose[1] + sim * torch.sin(ang)], -1)
        r = match_icp_points(pts[None], (sim < m.max_range)[None], scan_pts, scan_ok, pose[None],
                             iters=10, max_corr=0.6)
        liks.append(1e-6 if bool(r.fail[0]) else float(r.goodness[0]))
        poses.append(pose if bool(r.fail[0]) or not nudge else r.pose[0])
    log_w = state.log_w + torch.log(torch.tensor(liks) + 1e-12)
    return torch.stack(poses), log_w - torch.logsumexp(log_w, 0)


def test_update_is_a_loop_of_single_matches(room):
    """Poses and log-weights of the batched update against the loop. The
    match counts (so the weights) come out equal; the poses differ only in
    the float32 last bits of a 32-pair batch against a 1-pair one (torch's
    CPU ``atan2`` rounds its vectorised body and its scalar tail apart, as
    ``tests/test_torch_parallel.py`` shows), carried through 10
    iterations: 1e-5 m / rad is a hundred times that drift and a thousand
    times under a cell."""
    grid, state, ranges, valid = room
    got = pf.update_raycast_icp(state, grid, ROOM_MODEL, ranges, valid)
    poses, log_w = _one_by_one(grid, state, ranges, valid)
    np.testing.assert_allclose(got.poses.numpy(), poses.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.log_w.numpy(), log_w.numpy(), rtol=0, atol=1e-6)
    # In chunks of 5 particles the same, to the same drift.
    chunked = pf.update_raycast_icp(state, grid, ROOM_MODEL, ranges, valid, chunk=5)
    np.testing.assert_allclose(chunked.poses.numpy(), poses.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(chunked.log_w.numpy(), log_w.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("nudge", [True, False])
def test_update_is_the_references(room, nudge):
    """The benchmark's plain reference, composed of the frozen modules,
    gives the same update bit for bit on the CPU (one chunk on both
    sides)."""
    from benchmark.reference import localize_icp as ref

    grid, state, ranges, valid = room
    got = pf.update_raycast_icp(state, grid, ROOM_MODEL, ranges, valid, nudge=nudge)
    want = ref.update(state, grid, ROOM_MODEL, ranges, valid, nudge=nudge)
    assert torch.equal(got.log_w, want.log_w) and torch.equal(got.poses, want.poses)
    if not nudge:
        assert torch.equal(got.poses, state.poses)


def test_nudge_and_goodness():
    """A particle 0.2 m off the pose the scan was taken from is nudged
    closer; at that pose the match counts more points than 0.5 m off."""
    scans = preprocess(torch.as_tensor(room_ranges(POSES)), ROOM_MODEL)
    spec = spec_for_trajectory(POSES, ROOM_MODEL.max_range, 0.05)
    grid = integrate_scans(empty_grid(spec), ROOM_MODEL, scans, torch.as_tensor(POSES))
    true = torch.as_tensor(POSES[4])
    cloud = torch.stack([true, true + torch.tensor([0.2, 0.0, 0.0]),
                         true + torch.tensor([0.0, 0.5, 0.0])])
    state = pf.ParticleState(cloud, torch.full((3,), -np.log(3.0)))
    got = pf.update_raycast_icp(state, grid, ROOM_MODEL, scans.ranges[4], ~scans.bad[4])
    off = torch.hypot(*(cloud[1, :2] - true[:2]))
    moved = torch.hypot(*(got.poses[1, :2] - true[:2]))
    assert moved < 0.5 * off, (float(off), float(moved))
    assert float(torch.hypot(*(got.poses[0, :2] - true[:2]))) < 0.05
    kept = pf.update_raycast_icp(state, grid, ROOM_MODEL, scans.ranges[4], ~scans.bad[4],
                                 nudge=False)
    assert torch.equal(kept.poses, cloud) and torch.equal(kept.log_w, got.log_w)
    assert got.log_w[0] > got.log_w[2]


def test_failed_match_weighs_1e6(room):
    """A particle off the map simulates no hit, matches nothing and fails:
    its likelihood is 1e-6 and it is not moved."""
    grid, state, ranges, valid = room
    cloud = torch.cat([state.poses[:3], torch.tensor([[100.0, 100.0, 0.3]])])
    four = pf.ParticleState(cloud, torch.full((4,), -np.log(4.0)))
    got = pf.update_raycast_icp(four, grid, ROOM_MODEL, ranges, valid)
    assert torch.equal(got.poses[3], cloud[3])
    ok = pf.update_raycast_icp(pf.ParticleState(cloud[:1], torch.zeros(1)), grid, ROOM_MODEL,
                               ranges, valid)
    fi = ROOM_MODEL.bearings()
    scan_ok = valid & (ranges < ROOM_MODEL.max_range) & (ranges > ROOM_MODEL.min_range)
    sim = raycast.simulate_scan(grid, ROOM_MODEL, cloud[0])
    ang = cloud[0, 2] + fi
    pts = torch.stack([cloud[0, 0] + sim * torch.cos(ang), cloud[0, 1] + sim * torch.sin(ang)], -1)
    scan_pts = torch.stack([ranges * torch.cos(fi), ranges * torch.sin(fi)], -1)
    g = match_icp_points(pts[None], (sim < ROOM_MODEL.max_range)[None], scan_pts[None],
                         scan_ok[None], cloud[:1], iters=10, max_corr=0.6).goodness[0]
    gap = got.log_w[3] - got.log_w[0]
    want = torch.log(torch.tensor(1e-6) + 1e-12) - torch.log(g + 1e-12)
    assert abs(float(gap - want)) < 1e-5, (float(gap), float(want))
    assert torch.equal(ok.poses[0], got.poses[0])


def _icp_chunks(state, grid, ranges, valid, chunk):
    """The update and the search's chunks it counts."""
    profiler.reset()
    profiler.enable()
    try:
        got = pf.update_raycast_icp(state, grid, ROOM_MODEL, ranges, valid, chunk=chunk)
        return got, profiler.counts()["pf.icp_chunks"]
    finally:
        profiler.disable()
        profiler.reset()


def test_cpu_chunk_rule_and_chunk_argument_are_unchanged(room, monkeypatch):
    """On the CPU the plain search holds ``[P, N, N]``: as many particles
    a chunk as ``N² · BYTES_PER_PAIR`` (``icp_points.bytes_per_row``) fit
    ``CHUNK_BYTES``, in the fewest chunks of equal size (4 of 1024 at the
    icp cell's 4096 x 361); ``chunk=`` wins; the weights do not depend on
    the chunks, the poses only in the last bits of CPU ``atan2`` (as in
    the loop test above)."""
    cloud = torch.zeros(4096, 361, 2)
    assert icp_points.bytes_per_row(cloud, cloud) == 361 * 361 * icp_points.BYTES_PER_PAIR
    assert -(-4096 // pf._chunk(4096, icp_points.bytes_per_row(cloud, cloud), None)) == 4
    grid, state, ranges, valid = room
    n = ROOM_MODEL.n_beams
    # Twelve particles' [N, N] intermediates fill the chunk's bytes: 3 chunks of 11.
    monkeypatch.setattr(pf, "CHUNK_BYTES", 12 * n * n * icp_points.BYTES_PER_PAIR)
    whole, chunks = _icp_chunks(state, grid, ranges, valid, None)
    assert chunks == 3
    for chunk, want in ((5, 7), (32, 1), (100, 1)):
        got, chunks = _icp_chunks(state, grid, ranges, valid, chunk)
        assert chunks == want, chunk
        assert torch.equal(got.log_w, whole.log_w)
        np.testing.assert_allclose(got.poses.numpy(), whole.poses.numpy(), rtol=0, atol=1e-5)


def test_kernel_path_reckons_points_not_pairs(room, monkeypatch):
    """Where the kernel searches (CUDA float32, here its predicate made to
    say so on the CPU) an iteration holds ``[P, N]`` tensors, so the chunk
    reckons ``N · BYTES_PER_POINT`` a particle (``icp_points.bytes_per_row``):
    the icp cell's 4096 x 361 is one chunk, and the CHUNK_BYTES that cuts
    the plain search in 3 leaves the room's 32 particles whole; ``chunk=``
    still wins."""
    grid, state, ranges, valid = room
    n = ROOM_MODEL.n_beams
    cloud = torch.zeros(4096, 361, 2)
    with monkeypatch.context() as m:
        m.setattr(icp_points, "searches_on_kernel", lambda cur, ref: True)
        kernel_bytes = icp_points.bytes_per_row(cloud, cloud)
    assert kernel_bytes == 361 * icp_points.BYTES_PER_POINT
    assert pf._chunk(4096, kernel_bytes, None) == 4096
    # The update's chunks by the kernel's rule; its searches stay on the CPU's block.
    monkeypatch.setattr(icp_points, "bytes_per_row",
                        lambda cur, ref: cur.shape[-2] * icp_points.BYTES_PER_POINT)
    monkeypatch.setattr(pf, "CHUNK_BYTES", 12 * n * n * icp_points.BYTES_PER_PAIR)
    assert _icp_chunks(state, grid, ranges, valid, None)[1] == 1
    assert _icp_chunks(state, grid, ranges, valid, 5)[1] == 7
    # A budget of 10 particles' [N] tensors: 4 chunks of 8.
    monkeypatch.setattr(pf, "CHUNK_BYTES", 10 * n * icp_points.BYTES_PER_POINT)
    assert _icp_chunks(state, grid, ranges, valid, None)[1] == 4


def test_update_icp_keeps_its_results(room):
    """``update_icp`` through the helper it now shares: the same weights
    and poses as its own operations written out (the map cloud of the
    room's ten scans, chunks of 10)."""
    grid, state, ranges, valid = room
    scans = preprocess(torch.as_tensor(room_ranges(POSES)), ROOM_MODEL)
    fi = ROOM_MODEL.bearings()
    ang = torch.as_tensor(POSES[:, 2:3]) + fi
    map_pts = torch.stack([torch.as_tensor(POSES[:, 0:1]) + scans.ranges * torch.cos(ang),
                           torch.as_tensor(POSES[:, 1:2]) + scans.ranges * torch.sin(ang)],
                          -1).reshape(-1, 2)
    map_ok = (~scans.bad & (scans.ranges < ROOM_MODEL.max_range)).reshape(-1)
    scan_pts = torch.stack([ranges * torch.cos(fi), ranges * torch.sin(fi)], -1)
    for nudge in (True, False):
        got = pf.update_icp(state, map_pts, map_ok, ROOM_MODEL, scan_pts, valid, nudge=nudge,
                            chunk=10)
        res = [match_icp_points(map_pts.expand(b, -1, 2), map_ok.expand(b, -1),
                                scan_pts.expand(b, -1, 2), valid.expand(b, -1), p,
                                iters=10, max_corr=0.6)
               for p in state.poses.split(10) for b in (p.shape[0],)]
        fail = torch.cat([r.fail for r in res])
        lik = torch.where(fail, 1e-6, torch.cat([r.goodness for r in res]))
        moved = torch.cat([r.pose for r in res])
        poses = torch.where(fail[:, None], state.poses, moved) if nudge else state.poses
        log_w = state.log_w + torch.log(lik + 1e-12)
        assert torch.equal(got.log_w, log_w - torch.logsumexp(log_w, 0))
        assert torch.equal(got.poses, poses)


def test_program_icp_lap_matches_the_reference():
    """The port's ray-cast + ICP lap, tick for tick, against the
    benchmark's reference on the same draws: the same map and estimates
    bit for bit on the CPU."""
    import json

    from benchmark import traffic
    from benchmark.drivers.localize import make_draws
    from benchmark.drivers.replay import program_model
    from benchmark.reference import localize_icp as ref

    with open(os.path.join(ROOT, "benchmark", "configs", "fr079_icp.json")) as f:
        cfg = json.load(f)
    loc = dict(cfg["localization"], particles=24, resolution=0.25)
    log = traffic.make_log(cfg, 2**31 + 23, n_scans=20)
    split, ticks = 10, 3
    draws = make_draws(2**31 + 23, 1, log.ranges.shape[0] - split - 1, 24, "cpu")[0]
    model = program_model(log)
    scans = preprocess(torch.from_numpy(log.ranges), model)
    gt = torch.from_numpy(log.gt)
    spec = spec_for_trajectory(log.gt, model.max_range, loc["resolution"])
    grid = integrate_scans(empty_grid(spec), model, type(scans)(*(x[:split] for x in scans)),
                           gt[:split])
    state = pf.init_from_noise(gt[split], draws["init_xy"], draws["init_t"])
    ests = []
    for k in range(ticks):
        t = split + 1 + k
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        state = pf.predict_with_noise(state, se2.relative(gt[t - 1], gt[t]), draws["xy"][k],
                                      draws["t"][k], loc["predict_sigma_xy"],
                                      loc["predict_sigma_theta"])
        state = pf.update_raycast_icp(state, grid, model, scans.ranges[t], valid)
        state = pf.maybe_resample_at(state, draws["u"][k])
        ests.append(pf.estimate(state).numpy())
    want, want_grid = ref.lap(log, split, loc, draws, ticks, "cpu")
    np.testing.assert_array_equal(grid.log_odds.numpy(), want_grid)
    np.testing.assert_array_equal(np.stack(ests), want)
    err = np.hypot(*(want[:, :2] - log.gt[split + 1:split + 1 + ticks, :2]).T)
    assert err.max() < 0.5


@pytest.fixture(scope="module")
def small_log(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("icp") / "synthetic.log")
    synthetic_log.write_carmen(path, *synthetic_log.synthetic_log(n_scans=60, n_whips=0))
    return path


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_cli_localize_icp_runs_and_tracks(small_log, monkeypatch, capsys):
    args = ["--device", "cpu", "--particles", "48", "--steps", "12", "--resolution", "0.2"]
    calls = []
    for module, name in ((pf, "update_raycast_icp"), (pf, "update_beam"),
                         (pf, "update_field"), (raycast, "likelihood_field")):
        _spy(monkeypatch, module, name, calls)
    run = tcli.main(["localize", small_log, "--model", "icp", *args])
    assert "tracked 12 steps with 48 particles: pos err mean=" in capsys.readouterr().out
    # Every tick weighs with ray-cast + ICP; no likelihood field is built.
    assert calls == ["update_raycast_icp"] * 12
    assert run.errors.shape == (12,) and run.grid.spec.resolution == 0.2
    # The field's own bounds (tests/test_torch_facade.py).
    assert run.errors.mean() < 0.15 and np.percentile(run.errors, 90) < 0.3
    again = tcli.main(["localize", small_log, "--model", "icp", *args])
    np.testing.assert_array_equal(again.errors, run.errors)      # seeded


def test_facade_localization_takes_the_icp_model(room, monkeypatch):
    grid = room[0]
    true = POSES[5]
    scans = [room_ranges(true[None], seed=20 + k)[0] for k in range(3)]
    s = tfacade.SlamV1(ROOM_MODEL, work_mode="localization", localization_grid=grid,
                       n_particles=128, device="cpu", seed=4, observation_model="icp")
    calls = []
    for name in ("update_raycast_icp", "update_field", "global_relocalize"):
        _spy(monkeypatch, pf, name, calls)
    s.start()
    out = []
    for r in scans:
        s.feed_odometry(0.0, 0.0, 0.0)
        out.append(s.feed_scan_main(r))
    # Global relocalization on the first scan scores on the field; every
    # scan then weighs with ray-cast + ICP.
    assert calls == ["global_relocalize"] + ["update_raycast_icp"] * 3
    # The bound of the field's own test of this mode (tests/test_torch_facade.py).
    assert np.linalg.norm(out[-1][:2] - true[:2]) < 1.0
