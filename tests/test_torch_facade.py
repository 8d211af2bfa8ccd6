"""Port parity: the deployable surface. ``runtime/facade.SlamV1`` in both
work modes with every callback counted, ``nav/controller.
security_speed_cap``, and the ``localize`` and ``eval`` subcommands of the
CLI, against the JAX package on the CPU.

Tolerances: the mapping mode's poses as the online session's (2e-2 end to
end: per-pair PSM stops; the fused pose is a filter over them); the speed
cap and zone exact; ``cli eval`` 1e-4 (float32 reductions, four printed
decimals). The localization mode draws its own random numbers, which no
seed makes equal between ``jax.random`` and ``torch.Generator``: it is
held to the truth, as the JAX package's own test holds it.
"""

import argparse
import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu import cli as jcli
from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.mapping import occupancy as jocc
from laser_slam_tpu.nav import controller as jnav
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu.runtime import facade as jfacade
from laser_slam_tpu_torch import cli as tcli
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.nav import controller as tnav
from laser_slam_tpu_torch.runtime import facade as tfacade

from tests.conftest import box_room_ranges

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
END_TO_END_ATOL = 2e-2
CALLBACKS = [f.name for f in dataclasses.fields(tfacade.SlamCallbacks)]


def trajectory_scans(n=12, seed=0):
    rng = np.random.default_rng(seed)
    poses = np.asarray([(0.15 * i, 0.05 * i, 0.02 * i) for i in range(n)], np.float32)
    ranges = np.stack([box_room_ranges(MODEL, p) for p in poses])
    return poses, (ranges + rng.normal(0, 0.01, ranges.shape)).astype(np.float32)


def counting_callbacks(cls):
    """A callback table with every entry set, and what each received."""
    seen = {name: [] for name in CALLBACKS}

    def record(name):
        return lambda *args: seen[name].append([np.array(a) for a in args])

    return cls(**{name: record(name) for name in CALLBACKS}), seen


def drive_mapping(facade):
    _, ranges = trajectory_scans(8)
    out = []
    for i, r in enumerate(ranges):
        facade.feed_odometry(0.15 * i, 0.05 * i, 0.02 * i)
        if i == 3:
            facade.feed_beacon(0.4, 0.2, 0.0)
            facade.feed_gps((0.45, 0.15))
        facade.feed_scan_minor(r[::-1].copy())
        out.append(facade.feed_scan_main(r))
    facade.report_error(tfacade.SYS_LOST_CNC_SICK_A)
    facade.stop()
    assert facade.feed_scan_main(ranges[0]) is None       # stopped
    return np.stack(out)


def test_mapping_mode_matches_jax_and_every_callback_fires():
    assert jfacade.SlamCallbacks.__dataclass_fields__.keys() == \
        tfacade.SlamCallbacks.__dataclass_fields__.keys()
    jcb, jseen = counting_callbacks(jfacade.SlamCallbacks)
    tcb, tseen = counting_callbacks(tfacade.SlamCallbacks)
    j = jfacade.SlamV1(MODEL, callbacks=jcb, work_mode="mapping")
    t = tfacade.SlamV1(TMODEL, callbacks=tcb, work_mode="mapping", device="cpu")
    assert t.async_backend and t.pose.shape == (3,) and t.last_scan is None
    j.start()
    t.start()
    jout, tout = drive_mapping(j), drive_mapping(t)
    np.testing.assert_allclose(tout, jout, atol=END_TO_END_ATOL)
    # Every callback of the mapping mode fired as often as JAX's did.
    counts = {k: len(v) for k, v in tseen.items()}
    assert counts == {k: len(v) for k, v in jseen.items()}
    assert counts == {
        "on_fused_pose": 8, "on_slam_pose": 7, "on_odo_pose": 8, "on_beacon_pose": 1,
        "on_localization": 0, "on_pose_and_cloud": 8, "on_scan_a": 8, "on_scan_b": 8,
        "on_local_map": 8, "on_global_map": 0, "on_obstacle": 16, "on_error": 1}
    assert tseen["on_error"][0][0] == 3
    for name in ("on_fused_pose", "on_slam_pose", "on_odo_pose", "on_beacon_pose"):
        np.testing.assert_allclose(np.stack([a[0] for a in tseen[name]]),
                                   np.stack([a[0] for a in jseen[name]]), atol=END_TO_END_ATOL)
    # Obstacle layer: speed cap and zone, equal.
    np.testing.assert_array_equal(np.asarray(tseen["on_obstacle"], np.float32).reshape(16, 2),
                                  np.asarray(jseen["on_obstacle"], np.float32).reshape(16, 2))
    # Local maps: 100 x 100 probability windows of the live grid. The two
    # sessions' poses differ by mm, so samples near cell edges move: most
    # cells agree closely, all of them loosely.
    for (tw,), (jw,) in zip(tseen["on_local_map"], jseen["on_local_map"]):
        assert tw.shape == jw.shape == (100, 100) and tw.dtype == np.float32
        assert (np.abs(tw - jw) > 0.02).mean() < 0.02
    # The pose-and-cloud callback hands the fused pose and the raw ranges.
    pose, cloud = tseen["on_pose_and_cloud"][-1]
    np.testing.assert_array_equal(pose, tout[-1])
    assert cloud.shape == (MODEL.n_beams,)
    # Global map on request, through its callback.
    grid = t.global_map(0.1)
    assert len(tseen["on_global_map"]) == 1 and grid.log_odds.shape == (1200, 1200)
    assert t.last_scan.ranges.shape == (MODEL.n_beams,)
    np.testing.assert_allclose(t.pose, j.pose, atol=END_TO_END_ATOL)


# The localization mode's sensor: 10 m of range keeps the map's extent (and
# with it the share of the 10,000 relocalization samples that fall into
# free space) at what a room needs.
LOC_MODEL = dataclasses.replace(MODEL, max_range=10.0)
LOC_TMODEL = interop.model_from_fields(dataclasses.asdict(LOC_MODEL))


def asymmetric_room_scans(poses, seed=0):
    """Ranges ``[T, N]`` in the asymmetric room of ``tools/synthetic_log.py``
    (a plain box has a mirror image for every pose)."""
    rng = np.random.default_rng(seed)
    r = synthetic_log.ray_cast(synthetic_log.room_walls(), np.asarray(poses, np.float64),
                               np.asarray(LOC_MODEL.bearings(), np.float64), LOC_MODEL.max_range)
    return np.where(r <= LOC_MODEL.max_range, r + rng.normal(0, 0.01, r.shape), r).astype(np.float32)


def test_localization_mode_converges_near_truth():
    poses = np.asarray([(-1.0 + 0.15 * i, 1.0 - 0.05 * i, -1.0 + 0.3 * i) for i in range(10)],
                       np.float32)
    ranges = asymmetric_room_scans(poses)
    scans = jpp.preprocess(jnp.asarray(ranges), LOC_MODEL)
    spec = jocc.spec_for_trajectory(poses, LOC_MODEL.max_range, 0.05)
    jgrid = jocc.integrate_scans(jocc.empty_grid(spec), LOC_MODEL, scans, jnp.asarray(poses))
    tgrid = interop.grid_from_numpy(np.asarray(jgrid.log_odds), dataclasses.asdict(spec))
    tcb, seen = counting_callbacks(tfacade.SlamCallbacks)
    s = tfacade.SlamV1(LOC_TMODEL, callbacks=tcb, work_mode="localization", localization_grid=tgrid,
                       n_particles=512, device="cpu", seed=4)
    s.start()
    np.testing.assert_array_equal(s.pose, np.zeros(3, np.float32))     # odometry until a scan
    true = poses[5]
    for k in range(3):
        s.feed_odometry(0.0, 0.0, 0.0)
        est = s.feed_scan_main(asymmetric_room_scans(true[None], seed=20 + k)[0])
    counts = {k: len(v) for k, v in seen.items() if v}
    assert counts == {"on_localization": 3, "on_fused_pose": 3, "on_odo_pose": 3, "on_scan_a": 3,
                      "on_obstacle": 3}
    assert s._pf_state.n == 512 and est.shape == (3,)
    np.testing.assert_allclose(s.pose, est, atol=1e-6)
    # Global relocalization narrows to the right spot: the bound of the
    # JAX package's own test of this mode. The seed is fixed: three ticks
    # after a relocalization from ~800 free-space samples, the top-8 mean
    # still jumps between modes from seed to seed, in both packages.
    assert np.linalg.norm(est[:2] - true[:2]) < 1.0
    with pytest.raises(RuntimeError, match="mapping mode"):
        s.global_map()
    # The same seed gives the same estimates; another seed other draws.
    def again(seed):
        f = tfacade.SlamV1(LOC_TMODEL, work_mode="localization", localization_grid=tgrid,
                           n_particles=512, device="cpu", seed=seed)
        f.start()
        return f.feed_scan_main(asymmetric_room_scans(true[None])[0])
    np.testing.assert_array_equal(again(4), again(4))
    assert not np.array_equal(again(4), again(5))


def test_facade_refuses_what_it_cannot_run(monkeypatch):
    with pytest.raises(ValueError, match="localization_grid"):
        tfacade.SlamV1(TMODEL, work_mode="localization", device="cpu").start()
    with pytest.raises(ValueError, match="unknown work_mode"):
        tfacade.SlamV1(TMODEL, work_mode="patrol", device="cpu").start()
    idle = tfacade.SlamV1(TMODEL, device="cpu")
    assert idle.feed_scan_main(np.ones(MODEL.n_beams, np.float32)) is None     # not started
    idle.stop()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfacade.SlamV1(TMODEL)
    assert (tfacade.SYS_ERR_CTRL_BATTERY_LOW, tfacade.SYS_LOST_LOW_CTRL_SERIAL) == \
        (jfacade.SYS_ERR_CTRL_BATTERY_LOW, jfacade.SYS_LOST_LOW_CTRL_SERIAL) == (1, 6)


def test_stop_raises_when_a_round_failed_on_the_worker(monkeypatch):
    from laser_slam_tpu_torch.runtime import backend as tbackend

    def broken_round(self, *snap):
        raise FloatingPointError("solver blew up")

    s = tfacade.SlamV1(TMODEL, device="cpu")
    s.start()
    s.feed_scan_main(trajectory_scans(1)[1][0])
    monkeypatch.setattr(tbackend.IncrementalBackend, "round", broken_round)
    s._slam._schedule_backend()
    with pytest.raises(RuntimeError, match="backend round failed"):
        s.stop()
    assert s.feed_scan_main(np.ones(MODEL.n_beams, np.float32)) is None        # stopped all the same


@pytest.mark.parametrize("nearest", [0.05, 0.2, 0.3, 0.45, 0.6, 0.99, 1.2, 1.5, 2.4999, 2.5, 7.0, None])
def test_security_speed_cap_matches_jax(nearest):
    """One return at ``nearest`` metres dead ahead (``None``: nothing in
    the frontal cone), on the zones' own boundaries too: speed and zone
    equal JAX's. A return outside the cone, a bad beam and one below
    ``min_range`` are nearer and must not count."""
    r = np.full(MODEL.n_beams, 9.0, np.float32)
    bad = np.zeros(MODEL.n_beams, bool)
    if nearest is not None:
        r[90] = nearest
    r[2] = 0.2                     # 88° off axis: outside the 1 rad cone
    r[80], bad[80] = 0.25, True
    r[100] = 0.02
    seg = np.zeros(MODEL.n_beams, np.int32)
    js = jscan.Scan(jnp.asarray(r), jnp.asarray(bad), jnp.asarray(seg))
    jspeed, jzone = jnav.security_speed_cap(MODEL, js)
    tspeed, tzone = tnav.security_speed_cap(TMODEL, interop.scan_from_numpy(r, bad, seg))
    assert float(tspeed) == float(jspeed) and int(tzone) == int(jzone)
    assert tzone.dtype == torch.int32 and tspeed.dtype == torch.float32
    assert (tnav.ZONES, tnav.FREE_SPEED, tnav.ZONE_HALF_ANGLE) == \
        (jnav.ZONES, jnav.FREE_SPEED, jnav.ZONE_HALF_ANGLE)
    if nearest is not None and nearest <= 0.1:
        assert float(tspeed) == 1.0 and int(tzone) == -1      # below min_range: no return at all


# -- the CLI's localize and eval ----------------------------------------------

@pytest.fixture(scope="module")
def small_log(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("facade") / "synthetic.log")
    synthetic_log.write_carmen(path, *synthetic_log.synthetic_log(n_scans=80, n_whips=0))
    return path


def test_cli_eval_matches_jax(small_log, tmp_path, capsys):
    log_gt = synthetic_log.synthetic_log(n_scans=80, n_whips=0)[1]
    rng = np.random.default_rng(1)
    est = np.asarray(log_gt, np.float32)[:70] + rng.normal(0, 0.03, (70, 3)).astype(np.float32)
    traj = str(tmp_path / "traj.txt")
    np.savetxt(traj, est, fmt="%.6f")
    jcli.cmd_eval(argparse.Namespace(log=small_log, traj=traj))
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = tcli.main(["eval", small_log, traj, "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got and got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, k
    assert got["ate_rmse"] > 0.01


def test_cli_localize_tracks_the_second_half(small_log, capsys):
    """``cli localize`` as the JAX CLI runs it (map from the first half at
    the ground truth, 0.05 m cells, the particle filter over the second
    half): it draws its own numbers, so it is held to the ground truth; the
    JAX CLI's own line on this log reads a mean error of a few cm too."""
    run = tcli.main(["localize", small_log, "--device", "cpu", "--particles", "512",
                     "--steps", "25"])
    printed = capsys.readouterr().out
    assert "tracked 25 steps with 512 particles: pos err mean=" in printed
    assert run.errors.shape == (25,) and run.state.n == 512
    assert run.errors.mean() < 0.15 and np.percentile(run.errors, 90) < 0.3
    assert run.grid.spec.resolution == 0.05
    again = tcli.main(["localize", small_log, "--device", "cpu", "--particles", "512",
                       "--steps", "25"])
    np.testing.assert_array_equal(again.errors, run.errors)      # seeded


def test_cli_localize_and_eval_need_a_cuda_device_by_default(small_log, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["localize", small_log])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["eval", small_log, small_log])
