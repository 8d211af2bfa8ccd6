"""Port parity: the robot application layer (``app/config``, ``beacon``,
``task``, ``portal``, ``serial_ctrl``, ``robot``) of
``laser_slam_tpu_torch`` against ``laser_slam_tpu`` on the CPU.

Each test of ``test_app.py`` (and ``test_trajectory.py``'s task-engine
schedule) runs here on the port. Tolerances:

- ``trilaterate``: ``xy`` 1e-4 m, ``fail`` equal;
- ``TaskEngine``: the two engines run in lock step on the same poses and
  scans through the JAX tests' scenarios (and a blocked one that dodges):
  every tick's state equal, its command within 1e-5 (zones equal);
- ``RobotController``: both packages in mapping mode fed the same 20
  scans and odometry: fused poses within the online parity tests'
  end-to-end bound (2e-2: per-pair PSM stops differ in the last bits of
  ``atan2``/``cos``); every ``control_tick``'s task state equal. The
  local map is a function of the poses it is fed, which differ by that
  much, so the port's map is held (1e-4, ``origin_cell`` equal) against
  the JAX package's ``LocalMapService`` fed the same scans at the poses
  the port's controller streamed into it.
"""

import dataclasses
import socket
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.app import beacon as jbeacon
from laser_slam_tpu.app import robot as jrobot
from laser_slam_tpu.app import task as jtask
from laser_slam_tpu.app.config import RobotConfig as JRobotConfig
from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.mapping import occupancy as jocc
from laser_slam_tpu.nav import local_map as jlm
from laser_slam_tpu.ops import preprocess as jpp
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.app import (
    NetPortal,
    RobotController,
    TaskEngine,
    TaskState,
    load_config,
    parse_tags,
    trilaterate,
)
from laser_slam_tpu_torch.app import beacon as tbeacon
from laser_slam_tpu_torch.app.config import RobotConfig
from laser_slam_tpu_torch.ops import preprocess as tpp

from tests.conftest import box_room_ranges

MODEL = jscan.LMS211
TMODEL = interop.model_from_fields(dataclasses.asdict(MODEL))
CPU = "cpu"
CMD_ATOL = 1e-5
END_TO_END_ATOL = 2e-2
MAP_ATOL = 1e-4
T = lambda x: torch.tensor(np.asarray(x))      # noqa: E731  (a copy, as a tensor)


def tscan(ranges):
    s = tpp.preprocess(torch.tensor(np.asarray(ranges, np.float32))[None], TMODEL)
    return type(s)(*(x[0] for x in s))


def jscan_(ranges):
    return jax.tree.map(lambda a: a[0], jpp.preprocess(jnp.asarray(ranges, jnp.float32)[None],
                                                       MODEL))


def free_grid_lo(size=120):
    lo = -np.ones((size, size), np.float32)  # all free, walled
    lo[0, :] = 5.0
    lo[-1, :] = 5.0
    lo[:, 0] = 5.0
    lo[:, -1] = 5.0
    return lo


def grids(lo, res=0.1, ox=0.0, oy=0.0):
    spec = dict(origin_x=ox, origin_y=oy, resolution=res, width=lo.shape[1], height=lo.shape[0])
    return (jocc.OccupancyGrid(log_odds=jnp.asarray(lo), spec=jocc.GridSpec2D(**spec)),
            interop.grid_from_numpy(lo, spec))


def open_ranges():
    return np.full(181, 10.0, np.float32)


def engines(**kw):
    """The same task engine in both packages on the walled free grid."""
    jg, tg = grids(free_grid_lo())
    return jtask.TaskEngine(MODEL, jg, **kw), TaskEngine(TMODEL, tg, device=CPU, **kw)


def held(tcmd, jcmd):
    got = [float(x) for x in tcmd]
    want = [float(x) for x in jcmd]
    np.testing.assert_allclose(got, want, atol=CMD_ATOL, rtol=0)
    assert int(tcmd.zone) == int(jcmd.zone)


def lockstep(jeng, teng, pose, ranges):
    """One tick of both engines on the same pose and scan: states equal,
    commands within 1e-5. Returns the port's command."""
    jcmd = jeng.step(pose.copy(), jscan_(ranges))
    tcmd = teng.step(pose.copy(), tscan(ranges))
    assert teng.state.value == jeng.state.value
    held(tcmd, jcmd)
    return tcmd


# -- test_app.py -----------------------------------------------------------------

def test_config_parses_reference_style_xml(tmp_path):
    text = """<Params>
<IPA>192.168.0.161</IPA>
<PortA>8878</PortA>
<LaserBIP>192.168.1.6</LaserAIP>
<LaserBPort>8976</LaserAPort>
<LogFile>./robot.txt</LogFile>
<RobotID>18</RobotID>
<MainSICKWeight>0.5</MainSICKWeight>
<OriX>870</OriX>
<RunMode>3</RunMode>
<Robot_Len>0.8</Robot_Len>
"""
    p = tmp_path / "Conf.xml"
    p.write_text(text)
    cfg = load_config(str(p))
    assert cfg.slam_a.ip == "192.168.0.161" and cfg.slam_a.port == 8878
    assert cfg.laser_b.ip == "192.168.1.6" and cfg.laser_b.port == 8976
    assert cfg.robot_id == 18 and cfg.run_mode == 3
    assert abs(cfg.origin_x - 8.70) < 1e-6  # cm -> m
    assert cfg.raw["Robot_Len"] == "0.8"
    assert parse_tags("<A>1</A><A>2</A>")["A"] == "2"  # last wins


def test_trilateration_recovers_position():
    beacons = np.asarray([[0.0, 0.0], [10.0, 0.0], [0.0, 8.0], [10.0, 8.0]], np.float32)
    truth = np.asarray([3.0, 2.0], np.float32)
    rng = np.random.default_rng(0)
    ranges = (np.linalg.norm(beacons - truth[None, :], axis=-1)
              + rng.normal(0, 0.01, 4)).astype(np.float32)
    fix = trilaterate(T(beacons), T(ranges), torch.ones(4, dtype=torch.bool))
    assert not bool(fix.fail)
    assert float(torch.linalg.vector_norm(fix.xy - T(truth))) < 0.05
    assert float(fix.err) < 0.05
    fix2 = trilaterate(T(beacons), T(ranges), torch.tensor([True, True, False, False]))
    assert bool(fix2.fail)
    # Against JAX: seeded fixes, masks and initial guesses.
    for _ in range(10):
        b = rng.uniform(-10, 10, (6, 2)).astype(np.float32)
        xy = rng.uniform(-5, 5, 2).astype(np.float32)
        rr = (np.linalg.norm(b - xy, axis=-1) + rng.normal(0, 0.02, 6)).astype(np.float32)
        valid = rng.random(6) < 0.7
        init = None if rng.random() < 0.5 else rng.uniform(-5, 5, 2).astype(np.float32)
        want = jax.jit(jbeacon.trilaterate)(jnp.asarray(b), jnp.asarray(rr), jnp.asarray(valid),
                                            None if init is None else jnp.asarray(init))
        got = trilaterate(T(b), T(rr), T(valid), None if init is None else T(init))
        np.testing.assert_array_equal(got.fail.numpy(), np.asarray(want.fail))
        np.testing.assert_allclose(got.xy.numpy(), np.asarray(want.xy), atol=1e-4)
        np.testing.assert_allclose(got.err.numpy(), np.asarray(want.err), atol=1e-4)
    for a, b in [((0.0, 0.0), (1.0, 1.0)), ((0.0, 0.0), (0.01, 0.0))]:
        got = float(tbeacon.heading_from_fixes(T(np.float32(a)), T(np.float32(b))))
        want = float(jbeacon.heading_from_fixes(jnp.asarray(a), jnp.asarray(b)))
        assert (np.isnan(got) and np.isnan(want)) or abs(got - want) < 1e-6


def test_task_engine_plans_tracks_and_completes():
    jeng, eng = engines(goal_tolerance=0.3, robot_radius=0.2)
    assert eng.state is TaskState.IDLE
    for e in (jeng, eng):
        e.add_goal((8.0, 8.0))
    assert eng.state is TaskState.PLANNING
    r = open_ranges()
    pose = np.array([2.0, 2.0, 0.0], np.float32)
    cmd = lockstep(jeng, eng, pose, r)
    # The goal is 45° off the heading: turn in place first.
    assert eng.state is TaskState.TURNING
    assert float(cmd.v) == 0.0 and float(cmd.omega) != 0.0
    for _ in range(40):
        pose[2] += 0.05 * float(cmd.omega) / abs(float(cmd.omega))
        cmd = lockstep(jeng, eng, pose, r)
        if eng.state is TaskState.TRACKING:
            break
    assert eng.state is TaskState.TRACKING
    assert float(cmd.v) > 0.0
    np.testing.assert_array_equal(eng._path, np.asarray(jeng._path))
    assert eng._n_valid == jeng._n_valid
    cmd = lockstep(jeng, eng, np.array([8.0, 8.0, 0.0], np.float32), r)
    assert eng.state is TaskState.DONE
    assert float(cmd.v) == 0.0


def test_portal_command_roundtrip():
    goals, cancels = [], []
    portal = NetPortal(
        on_goto=lambda x, y: goals.append((x, y)),
        on_cancel=lambda: cancels.append(1),
        get_pose=lambda: (1.0, 2.0, 0.5),
        get_state=lambda: "tracking",
    )
    portal.start()
    try:
        with socket.create_connection(("127.0.0.1", portal.port), timeout=5) as c:
            f = c.makefile("rw", encoding="utf-8", newline="\n")
            for cmd, expect in [
                ("PING", "PONG"),
                ("GOTO 3.5 -1.25", "OK"),
                ("POSE", "POSE 1.0000 2.0000 0.5000"),
                ("STATE", "STATE tracking"),
                ("CANCEL", "OK"),
                ("BOGUS", "ERR unknown"),
            ]:
                f.write(cmd + "\n")
                f.flush()
                assert f.readline().strip() == expect
    finally:
        portal.stop()
    assert goals == [(3.5, -1.25)] and cancels == [1]


def test_robot_controller_smoke(tmp_path):
    from tests.test_features import _room_ranges

    cfg = RobotConfig(log_file=str(tmp_path / "robot.log"))
    bot = RobotController(TMODEL, config=cfg, work_mode="mapping", device=CPU)
    try:
        for i in range(3):
            bot.on_odometry(0.1 * i, 0.0, 0.0)
            pose = bot.on_scan_main(_room_ranges((0.1 * i, 0.0, 0.0), seed=i))
            assert pose is not None
        assert bot.control_tick() is None  # no task engine without a grid
        assert bot.local_map.map.log_odds.device.type == "cpu"
    finally:
        bot.shutdown()
    assert (tmp_path / "robot.log").exists()


def test_motor_link_frames_and_replies():
    from laser_slam_tpu_torch.app.serial_ctrl import (
        CMD_DRIVE,
        LoopbackTransport,
        MotorLink,
        decode_frames,
        encode_frame,
    )

    f = encode_frame(CMD_DRIVE, b"\x01\x02")
    buf = bytearray(b"\xff\x00" + f + f[:3])
    assert decode_frames(buf) == [(CMD_DRIVE, b"\x01\x02")]
    assert bytes(buf) == f[:3]  # partial frame retained
    bad = bytearray(f)
    bad[-1] ^= 0xFF
    assert decode_frames(bad) == []

    link = MotorLink(LoopbackTransport(), wheel_base=0.5)
    link.drive(0.5, 0.2)          # v, omega -> vL=0.45, vR=0.55
    link.request_odometry()
    link.request_status()
    link.poll()
    assert link.last_odometry is not None
    assert abs(link.last_odometry.x - 1.5) < 1e-9
    assert abs(link.last_odometry.theta - 0.7854) < 1e-9
    assert link.last_status.battery_mv == 24000
    frames = decode_frames(bytearray(b"".join(link._t.written)))
    vL, vR, _, _ = struct.unpack("<hhHH", frames[0][1])
    assert (vL, vR) == (450, 550)


def test_task_engine_path_and_slow_stop():
    jeng, eng = engines(goal_tolerance=0.3, robot_radius=0.2, face_tolerance=10.0)
    for e in (jeng, eng):
        e.add_path([(5.0, 2.0), (8.0, 2.0)], speed_limits=[0.3, 0.8])
    r = open_ranges()
    pose = np.array([2.0, 2.0, 0.0], np.float32)
    cmd = lockstep(jeng, eng, pose, r)
    assert eng.state is TaskState.TRACKING
    assert 0.0 < float(cmd.v) <= 0.3 + 1e-6       # the first leg's cap binds
    for e in (jeng, eng):
        e.slow_stop()
    assert eng.state is TaskState.STOPPING
    vs = [float(lockstep(jeng, eng, pose, r).v) for _ in range(eng.stop_decel_ticks + 1)]
    assert eng.state is TaskState.IDLE
    assert vs[-1] == 0.0
    assert all(a >= b for a, b in zip(vs, vs[1:]))  # monotone ramp


def test_task_engine_replace_path():
    jeng, eng = engines(goal_tolerance=0.3, robot_radius=0.2, face_tolerance=10.0)
    for e in (jeng, eng):
        e.add_goal((8.0, 8.0))
    r = open_ranges()
    pose = np.array([2.0, 2.0, 0.0], np.float32)
    lockstep(jeng, eng, pose, r)
    assert eng.state is TaskState.TRACKING
    for e in (jeng, eng):
        e.replace_path([(2.0, 6.0)])
    assert eng.state is TaskState.PLANNING
    lockstep(jeng, eng, pose, r)
    assert eng.state is TaskState.TRACKING
    assert list(map(tuple, eng._goals)) == [(2.0, 6.0)]


def test_portal_path_stop_heartbeat():
    import time as _time

    paths, repaths, stops, lost = [], [], [], []
    portal = NetPortal(
        on_path=paths.append,
        on_repath=repaths.append,
        on_slow_stop=lambda: stops.append(1),
        on_heartbeat_lost=lambda: lost.append(1),
        heartbeat_timeout=0.5,
    )
    portal.start()
    try:
        with socket.create_connection(("127.0.0.1", portal.port), timeout=5) as c:
            f = c.makefile("rw", encoding="utf-8", newline="\n")
            for cmd, expect in [
                ("PATH 1.0 2.0 3.0 4.0", "OK"),
                ("REPATH 5.0 6.0", "OK"),
                ("PATH 1.0", "ERR bad args"),
                ("STOP", "OK"),
                ("HEART", "BEAT"),
            ]:
                f.write(cmd + "\n")
                f.flush()
                assert f.readline().strip() == expect
        deadline = _time.time() + 5.0
        while not lost and _time.time() < deadline:
            _time.sleep(0.1)
    finally:
        portal.stop()
    assert paths == [[(1.0, 2.0), (3.0, 4.0)]]
    assert repaths == [[(5.0, 6.0)]]
    assert stops == [1] and lost == [1]


# -- test_trajectory.py: the engine's velocity schedule ------------------------------

def test_task_engine_velocity_schedule():
    jeng, eng = engines(robot_radius=0.2, face_tolerance=10.0)
    assert eng.velocity_schedule() is None
    for e in (jeng, eng):
        e.add_goal((8.0, 2.0), speed_limit=0.4)
    lockstep(jeng, eng, np.array([2.0, 2.0, 0.0], np.float32), open_ranges())
    assert eng.state is TaskState.TRACKING
    sched = eng.velocity_schedule()
    assert sched is not None and sched.v.device.type == "cpu"
    v = sched.v.numpy()[sched.valid.numpy()]
    assert v.max() <= 0.4 + 1e-5          # leg speed cap respected
    want = jeng.velocity_schedule()
    for k, x in interop.named_state_to_numpy(sched).items():
        np.testing.assert_allclose(x, np.asarray(getattr(want, k)), atol=1e-5, err_msg=k)


# -- the task engine against JAX, blocked -------------------------------------------

def test_task_engine_dodges_and_replans_like_jax():
    """A post 0.29 m away at 50-55° to the right holds zone 0: after five
    blocked ticks both engines take the local milestone dodge on the live
    scan; blocked again on the dodge leg they replan; past
    ``max_replans`` they fail. Lock step through every state."""
    jeng, eng = engines(goal_tolerance=0.3, robot_radius=0.2, face_tolerance=10.0)
    for e in (jeng, eng):
        e.add_goal((9.0, 6.0))
    blocked = open_ranges()
    mid = MODEL.n_beams // 2
    blocked[mid - 56: mid - 48] = 0.29         # a post ahead on the right
    pose = np.array([2.0, 6.0, 0.0], np.float32)
    seen = []
    for tick in range(40):
        cmd = lockstep(jeng, eng, pose, blocked if tick < 30 else open_ranges())
        seen.append(eng.state)
        if eng.state is TaskState.DODGING:
            np.testing.assert_allclose(eng._path, np.asarray(jeng._path), atol=1e-6)
        pose[0] += 0.1 * float(cmd.v) * np.cos(pose[2])
        pose[1] += 0.1 * float(cmd.v) * np.sin(pose[2])
        pose[2] += 0.1 * float(cmd.omega)
        if eng.state is TaskState.FAILED:
            break
    assert TaskState.DODGING in seen
    assert eng.n_dodges >= 1 and eng.n_plans >= 2


# -- RobotController against JAX -----------------------------------------------------

BOX = (-3.0, 5.0, -4.0, 4.0)


def box_grid_lo():
    """The box room of ``box_room_ranges`` as a 0.1 m occupancy grid
    (origin -3.5, -4.5): walls occupied, the inside free."""
    lo = np.full((90, 90), 5.0, np.float32)
    lo[6:85, 6:85] = -1.0       # cells 5 and 85 hold the walls at -4/4 and -3/5
    return lo


def robot_inputs(n=20, seed=0):
    rng = np.random.default_rng(seed)
    poses = np.asarray([(0.1 * i, 0.03 * i, 0.015 * i) for i in range(n)], np.float32)
    ranges = np.stack([box_room_ranges(MODEL, p, BOX) for p in poses])
    return poses, (ranges + rng.normal(0, 0.01, ranges.shape)).astype(np.float32)


def test_robot_controller_matches_jax(tmp_path):
    """Both controllers in mapping mode with a grid (so with a task
    engine), fed 20 scans and odometry, a goal queued after the first
    scan, ``control_tick`` after every scan."""
    poses, ranges = robot_inputs()
    jg, tg = grids(box_grid_lo(), ox=-3.5, oy=-4.5)
    jbot = jrobot.RobotController(MODEL, config=JRobotConfig(log_file=str(tmp_path / "j.log")),
                                  work_mode="mapping", localization_grid=jg)
    bot = RobotController(TMODEL, config=RobotConfig(log_file=str(tmp_path / "t.log")),
                          work_mode="mapping", localization_grid=tg, device=CPU)
    streamed = []
    stream_in = bot.local_map.stream_in
    bot.local_map.stream_in = lambda scan, pose: (
        streamed.append((interop.scan_to_numpy(scan), np.array(pose))), stream_in(scan, pose))[1]
    try:
        states = []
        for i, (p, r) in enumerate(zip(poses, ranges)):
            for b in (jbot, bot):
                b.on_odometry(*p)
            jp, tp = jbot.on_scan_main(r), bot.on_scan_main(r)
            np.testing.assert_allclose(tp, jp, atol=END_TO_END_ATOL)
            if i == 0:
                for b in (jbot, bot):
                    b._goto(3.5, -2.5)
            jc, tc = jbot.control_tick(), bot.control_tick()
            assert bot.tasks.state.value == jbot.tasks.state.value
            assert np.isfinite([float(x) for x in tc]).all() and int(tc.zone) == int(jc.zone)
            states.append(bot.tasks.state)
        assert TaskState.TRACKING in states or TaskState.TURNING in states
        np.testing.assert_allclose(bot.slam.pose, jbot.slam.pose, atol=END_TO_END_ATOL)
    finally:
        jbot.shutdown()
        bot.shutdown()
    # The port's local map against JAX's service fed what the port fed.
    jsvc = jlm.LocalMapService(MODEL)
    for (r, bad, seg), pose in streamed:
        jsvc.stream_in(jax.tree.map(jnp.asarray, jscan.Scan(r, bad, seg)), pose)
    assert len(streamed) == len(poses)
    lo, origin, res = interop.local_map_to_numpy(bot.local_map.map)
    np.testing.assert_array_equal(origin, np.asarray(jsvc.map.origin_cell))
    np.testing.assert_allclose(lo, np.asarray(jsvc.map.log_odds), atol=MAP_ATOL, rtol=0)
    assert (lo > 1.0).sum() > 50


def test_robot_controller_portal_and_device(tmp_path, monkeypatch):
    """The portal of a controller with a grid answers PING, GOTO, POSE,
    STATE and MAP; without ``device`` the controller asks for cuda and
    raises where there is none."""
    import base64
    import zlib

    _, tg = grids(box_grid_lo(), ox=-3.5, oy=-4.5)
    poses, ranges = robot_inputs(3)
    bot = RobotController(TMODEL, config=RobotConfig(log_file=str(tmp_path / "t.log")),
                          localization_grid=tg, enable_portal=True, device=CPU)
    try:
        for p, r in zip(poses, ranges):
            bot.on_odometry(*p)
            bot.on_scan_main(r)
        with socket.create_connection(("127.0.0.1", bot.portal.port), timeout=5) as c:
            f = c.makefile("rw", encoding="utf-8", newline="\n")

            def ask(line):
                f.write(line + "\n")
                f.flush()
                return f.readline().strip()

            assert ask("PING") == "PONG"
            assert ask("GOTO 3.5 -2.5") == "OK"
            assert ask("POSE").startswith("POSE ")
            assert ask("STATE") == "STATE planning"
            parts = ask("MAP").split()
            assert parts[:4] == ["MAP", "128", "128", "0.100"]
            assert len(zlib.decompress(base64.b64decode(parts[4]))) == 128 * 128
        cmd = bot.control_tick()
        assert bot.tasks.state in (TaskState.TURNING, TaskState.TRACKING)
        assert cmd.v.device.type == "cpu"
    finally:
        bot.shutdown()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RobotController(TMODEL, config=RobotConfig(log_file=str(tmp_path / "u.log")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TaskEngine(TMODEL, tg)


# -- a closed drive on the synthetic floor against JAX ---------------------------------

@pytest.fixture(scope="module")
def floor():
    """The synthetic floor integrated at the log's ground truth (0.05 m,
    world frame) in both packages, and the log's poses."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    import synthetic_log

    from laser_slam_tpu_torch.mapping import occupancy as tocc

    ranges, gt, _ = synthetic_log.synthetic_log()
    pad = np.concatenate([ranges, np.full((len(ranges), 1), MODEL.max_range + 1.0, np.float32)], 1)
    spec = tocc.GridSpec2D(-0.5, -0.5, 0.05, 380, 260)
    grid = tocc.integrate_scans(tocc.empty_grid(spec), TMODEL,
                                tpp.preprocess(torch.tensor(pad), TMODEL),
                                torch.tensor(gt, dtype=torch.float32))
    jg, _ = grids(grid.log_odds.numpy(), res=0.05, ox=-0.5, oy=-0.5)
    return jg, grid, gt


@pytest.mark.parametrize("legs,end", [
    (((4.2, 9.8), (3.5, 6.0), (14.5, 6.0)), "done"),      # the drive of chip_smoke.py
    (((4.2, 9.8), (9.5, 9.8), (15.0, 10.0)), "failed"),   # around a door jamb
])
def test_task_engine_drives_the_floor_like_jax(floor, legs, end):
    """Both engines at their defaults drive a simulated robot (scans
    ray-cast at the true pose with the port's ``simulate_scan``, the same
    ranges to both) through a two-leg path from the log's ground truth, in
    lock step: every tick's state equal, commands within 1e-5. Through
    room 1's doorway head-on and along the hall both reach the goal; on
    the way from room 1 to room 2 pure pursuit cuts the path's corner at
    the door jamb, the robot's centre comes within its radius of the jamb
    and both end FAILED after the same ticks."""
    from laser_slam_tpu_torch.localization.raycast import simulate_scan
    from laser_slam_tpu_torch.nav.planner import inflate_obstacles

    jg, grid, gt = floor
    near = lambda xy: gt[int(np.argmin(np.linalg.norm(gt[:, :2] - np.asarray(xy), axis=1)))]  # noqa: E731
    jeng, eng = jtask.TaskEngine(MODEL, jg), TaskEngine(TMODEL, grid, device=CPU)
    for e in (jeng, eng):
        e.add_path([near(xy)[:2] for xy in legs[1:]])
    blocked = inflate_obstacles(grid, eng.robot_radius).numpy()
    pose, inside = near(legs[0]).astype(np.float64), 0
    for tick in range(600):
        r = simulate_scan(grid, TMODEL, torch.tensor(pose, dtype=torch.float32)).numpy()
        cmd = lockstep(jeng, eng, pose.astype(np.float32), r)
        inside += bool(blocked[int((pose[1] + 0.5) / 0.05), int((pose[0] + 0.5) / 0.05)])
        if eng.state in (TaskState.DONE, TaskState.FAILED):
            break
        pose[0] += 0.1 * float(cmd.v) * np.cos(pose[2])
        pose[1] += 0.1 * float(cmd.v) * np.sin(pose[2])
        pose[2] = (pose[2] + 0.1 * float(cmd.omega) + np.pi) % (2 * np.pi) - np.pi
    assert eng.state.value == end
    assert (inside == 0) == (end == "done")
