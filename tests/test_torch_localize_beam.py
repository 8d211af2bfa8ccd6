"""The ray-cast beam model on the port's normal paths, on the CPU:
``cli localize --model beam``, ``SlamV1``'s localization mode with
``observation_model="beam"``, the spans and counters of
``particle_filter.update_beam``, and a lap of the port's beam-model
filter against the benchmark's plain reference
(``benchmark/reference/localize_beam.py``) on the same draws.

The beam model marches every beam to the sensor's full range (the
synthetic log's 50 m), so the CLI runs here on a coarse map (0.2 m
cells) with a small cloud; ``--model field`` is run at the same size as
the yardstick of accuracy.
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
from laser_slam_tpu_torch.io.carmen import read_carmen
from laser_slam_tpu_torch.localization import particle_filter as pf
from laser_slam_tpu_torch.localization import raycast
from laser_slam_tpu_torch.mapping.occupancy import (
    empty_grid,
    integrate_scans,
    spec_for_trajectory,
)
from laser_slam_tpu_torch.ops.preprocess import preprocess
from laser_slam_tpu_torch.runtime import facade as tfacade
from laser_slam_tpu_torch.utils.profiling import profiler

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)
import synthetic_log  # noqa: E402

torch.set_num_threads(1)

CLI_SIZE = ["--device", "cpu", "--particles", "64", "--steps", "20", "--resolution", "0.2"]
# A room-sized sensor keeps the ladder short: 10 m at 5 cm is 200 samples.
ROOM_MODEL = dataclasses.replace(LMS211, max_range=10.0)


@pytest.fixture(scope="module")
def small_log(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("beam") / "synthetic.log")
    synthetic_log.write_carmen(path, *synthetic_log.synthetic_log(n_scans=80, n_whips=0))
    return path


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)


def test_cli_localize_beam_runs_update_beam_and_tracks(small_log, monkeypatch, capsys):
    field = tcli.main(["localize", small_log, "--model", "field", *CLI_SIZE])
    calls = []
    for module, name in ((pf, "update_beam"), (pf, "update_field"),
                         (raycast, "likelihood_field")):
        _spy(monkeypatch, module, name, calls)
    beam = tcli.main(["localize", small_log, "--model", "beam", *CLI_SIZE])
    assert "tracked 20 steps with 64 particles: pos err mean=" in capsys.readouterr().out
    # Every tick weighs with the beam model; no likelihood field is built.
    assert calls == ["update_beam"] * 20
    assert beam.errors.shape == (20,) and beam.grid.spec.resolution == 0.2
    # The field's own bounds (tests/test_torch_facade.py), which the field
    # meets here too, and within twice the field's mean error.
    for run in (field, beam):
        assert run.errors.mean() < 0.15 and np.percentile(run.errors, 90) < 0.3
    assert beam.errors.mean() < 2.0 * field.errors.mean()
    again = tcli.main(["localize", small_log, "--model", "beam", *CLI_SIZE])
    np.testing.assert_array_equal(again.errors, beam.errors)      # seeded


def _field_localize_as_before(path, particles, steps, resolution):
    """``cmd_localize``'s tick loop as it was before it took a model: the
    likelihood field on every tick."""
    log = read_carmen(path, max_scans=None)
    model, dev = log.model, torch.device("cpu")
    scans = preprocess(torch.as_tensor(log.ranges, device=dev), model)
    gt = torch.as_tensor(log.gt_pose[: log.n_scans], dtype=torch.float32, device=dev)
    split = log.n_scans // 2
    spec = spec_for_trajectory(log.gt_pose[: log.n_scans], model.max_range, resolution)
    grid = integrate_scans(
        empty_grid(spec, device=dev), model, type(scans)(*(x[:split] for x in scans)), gt[:split])
    field = raycast.likelihood_field(grid)
    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    state = pf.init_gaussian(generator, gt[split], particles)
    ests = []
    for t in range(split + 1, min(split + 1 + steps, log.n_scans)):
        rel = se2.relative(gt[t - 1], gt[t])
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        state = pf.predict(state, rel, generator, sigma_xy=0.05, sigma_theta=0.03)
        state = pf.update_field(state, field, grid, model, scans.ranges[t], valid)
        state = pf.maybe_resample(state, generator)
        ests.append(pf.estimate(state))
    est = torch.stack(ests)
    return torch.sqrt(torch.sum((est[:, :2] - gt[split + 1:split + 1 + len(ests), :2]) ** 2,
                                dim=-1)).numpy()


def test_cli_localize_field_is_unchanged(small_log):
    args = ["--device", "cpu", "--particles", "256", "--steps", "15"]
    default = tcli.main(["localize", small_log, *args])
    field = tcli.main(["localize", small_log, "--model", "field", *args])
    np.testing.assert_array_equal(default.errors, field.errors)
    np.testing.assert_array_equal(field.errors, _field_localize_as_before(small_log, 256, 15, 0.05))
    with pytest.raises(SystemExit):
        tcli.main(["localize", small_log, "--model", "sonar", *args])


def room_ranges(poses, seed=0):
    """Ranges ``[T, N]`` in the asymmetric room of ``tools/synthetic_log.py``
    (a plain box has a mirror image for every pose)."""
    rng = np.random.default_rng(seed)
    bearings = np.asarray(ROOM_MODEL.bearings(torch.float64), np.float64)
    r = synthetic_log.ray_cast(synthetic_log.room_walls(), np.asarray(poses, np.float64),
                               bearings, ROOM_MODEL.max_range)
    return np.where(r <= ROOM_MODEL.max_range, r + rng.normal(0, 0.01, r.shape),
                    r).astype(np.float32)


def _room(resolution=0.05):
    poses = np.asarray([(-1.0 + 0.15 * i, 1.0 - 0.05 * i, -1.0 + 0.3 * i) for i in range(10)],
                       np.float32)
    scans = preprocess(torch.as_tensor(room_ranges(poses)), ROOM_MODEL)
    spec = spec_for_trajectory(poses, ROOM_MODEL.max_range, resolution)
    grid = integrate_scans(empty_grid(spec), ROOM_MODEL, scans, torch.as_tensor(poses))
    return poses, scans, grid


@pytest.mark.parametrize("chunk", [None, 5])
def test_update_beam_spans_counters_and_bits(chunk):
    poses, scans, grid = _room()
    g = torch.Generator().manual_seed(3)
    state = pf.init_gaussian(g, torch.as_tensor(poses[2]), 12, sigma_xy=0.1, sigma_theta=0.05)
    ranges, valid = scans.ranges[2], ~scans.bad[2] & (scans.ranges[2] < ROOM_MODEL.max_range)

    profiler.disable()
    profiler.reset()
    off = pf.update_beam(state, grid, ROOM_MODEL, ranges, valid, chunk=chunk)
    assert profiler.report() == {} and profiler.counts() == {}
    profiler.enable()
    try:
        on = pf.update_beam(state, grid, ROOM_MODEL, ranges, valid, chunk=chunk)
        spans, counts = profiler.report(), profiler.counts()
    finally:
        profiler.disable()
        profiler.reset()
    assert torch.equal(on.log_w, off.log_w) and torch.equal(on.poses, off.poses)
    assert spans["pf.update"]["count"] == 1 and spans["pf.raycast"]["count"] == 1
    assert spans["pf.raycast"]["total"] <= spans["pf.update"]["total"]
    assert counts == {"pf.raycast_rays": 12 * 181,
                      "pf.raycast_chunks": 1 if chunk is None else -(-12 // chunk)}
    # The chunk size does not change the result.
    whole = pf.update_beam(state, grid, ROOM_MODEL, ranges, valid)
    assert torch.equal(whole.log_w, off.log_w)

    # Under a profiler window both spans are ranges on the trace.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pf.update_beam(state, grid, ROOM_MODEL, ranges, valid, chunk=chunk)
    names = {e.name for e in prof.events()}
    assert {"pf.update", "pf.raycast"} <= names
    profiler.reset()


def test_program_beam_lap_matches_the_reference():
    """The port's beam-model lap, tick for tick, against the benchmark's
    plain reference on the same draws: the same map and the same estimates
    bit for bit on the CPU."""
    import json

    from benchmark import traffic
    from benchmark.drivers.localize import make_draws
    from benchmark.drivers.replay import program_model
    from benchmark.reference import localize_beam as ref

    with open(os.path.join(ROOT, "benchmark", "configs", "fr079_raycast.json")) as f:
        cfg = json.load(f)
    loc = dict(cfg["localization"], particles=32, resolution=0.25)
    log = traffic.make_log(cfg, 2**31 + 21, n_scans=24)
    split, ticks = 12, 5
    draws = make_draws(2**31 + 21, 1, log.ranges.shape[0] - split - 1, 32, "cpu")[0]

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
        state = pf.update_beam(state, grid, model, scans.ranges[t], valid,
                               sigma=loc["beam_sigma"])
        state = pf.maybe_resample_at(state, draws["u"][k])
        ests.append(pf.estimate(state).numpy())

    want, want_grid = ref.lap(log, split, loc, draws, ticks, "cpu")
    np.testing.assert_array_equal(grid.log_odds.numpy(), want_grid)
    np.testing.assert_array_equal(np.stack(ests), want)
    err = np.hypot(*(want[:, :2] - log.gt[split + 1:split + 1 + ticks, :2]).T)
    assert err.max() < 0.5


def test_facade_localization_takes_the_beam_model(monkeypatch):
    poses, _, grid = _room()
    true = poses[5]
    scans = [room_ranges(true[None], seed=20 + k)[0] for k in range(3)]

    def drive(**kw):
        s = tfacade.SlamV1(ROOM_MODEL, work_mode="localization", localization_grid=grid,
                           n_particles=256, device="cpu", seed=4, **kw)
        s.start()
        out = []
        for r in scans:
            s.feed_odometry(0.0, 0.0, 0.0)
            out.append(s.feed_scan_main(r))
        return np.stack(out)

    calls = []
    for name in ("update_beam", "update_field", "global_relocalize"):
        _spy(monkeypatch, pf, name, calls)
    beam = drive(observation_model="beam")
    # Global relocalization on the first scan scores on the field; every
    # scan then weighs with the beam model.
    assert calls == ["global_relocalize", "update_beam", "update_beam", "update_beam"]
    # The bound of the field's own test of this mode (tests/test_torch_facade.py).
    assert np.linalg.norm(beam[-1, :2] - true[:2]) < 1.0

    calls.clear()
    default = drive()
    assert calls == ["global_relocalize", "update_field", "update_field", "update_field"]
    np.testing.assert_array_equal(default, drive(observation_model="field"))
    with pytest.raises(ValueError, match="observation_model"):
        tfacade.SlamV1(ROOM_MODEL, work_mode="localization", localization_grid=grid,
                       device="cpu", observation_model="sonar").start()
