"""Port parity: the mission layer (corner blending, wheel schedules,
mission scripts, the system monitor, the scripted mission over the
portal) of ``laser_slam_tpu_torch`` against ``laser_slam_tpu`` on the CPU.

Each test of ``test_mission.py`` runs here on the port. The mission
runners of both packages drive their task engines in lock step on the
same simulated poses and scans: every tick's runner status and engine
state equal, the commands within 1e-5; the blends within 1e-5.
"""

import base64
import socket
import zlib

import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)

from laser_slam_tpu.app import mission as jmission
from laser_slam_tpu.app import task as jtask
from laser_slam_tpu.nav import trajectory as jtr
from laser_slam_tpu_torch.app.mission import LegAction, Mission, MissionRunner, MissionStatus
from laser_slam_tpu_torch.app.monitor import (
    SYS_ERR_CTRL_BATTERY_LOW, SYS_LOST_CNC_SICK_A, SYS_OK, SystemMonitor,
)
from laser_slam_tpu_torch.app.portal import NetPortal
from laser_slam_tpu_torch.app.task import TaskEngine
from laser_slam_tpu_torch.nav.trajectory import blend_corner, blend_path, wheel_schedule_along

from tests.test_torch_app import CPU, MODEL, TMODEL, free_grid_lo, grids, held, jscan_, open_ranges, tscan

ATOL = 1e-5


# -- corner blending -----------------------------------------------------------------

def test_blend_corner_cuts_a_right_angle_smoothly():
    p0, p1, p2 = [0.0, 0.0], [2.0, 0.0], [2.0, 2.0]
    out = blend_corner(torch.tensor(p0), torch.tensor(p1), torch.tensor(p2), n_slices=200)
    assert bool(out.ok)
    xy = out.xy.numpy()
    assert np.linalg.norm(xy[0] - p0) < 1e-5
    assert np.linalg.norm(xy[-1] - np.asarray(p2)) < 1e-4
    d_corner = np.linalg.norm(xy - np.asarray(p1), axis=1).min()
    assert 0.05 < d_corner < 1.0          # cuts the corner
    seg = np.diff(xy, axis=0)
    head = np.unwrap(np.arctan2(seg[:, 1], seg[:, 0]))
    assert np.abs(np.diff(head)).max() < 0.3
    want = jtr.blend_corner(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(p2), n_slices=200)
    np.testing.assert_allclose(xy, np.asarray(want.xy), atol=ATOL)


def test_blend_corner_flags_degenerate_uturn():
    out = blend_corner(torch.tensor([0.0, 0.0]), torch.tensor([2.0, 0.0]),
                       torch.tensor([0.0, 0.01]), n_slices=50)
    assert not bool(out.ok)


def test_blend_path_densifies_and_keeps_endpoints():
    path = np.array([[0, 0], [2, 0], [2, 2], [4, 2]], np.float32)
    smooth = blend_path(path, n_slices=40, device=CPU)
    assert len(smooth) > len(path)
    assert np.linalg.norm(smooth[0] - path[0]) < 1e-5
    assert np.linalg.norm(smooth[-1] - path[-1]) < 1e-5
    np.testing.assert_allclose(smooth, jtr.blend_path(path, n_slices=40), atol=ATOL)


def test_wheel_schedule_along_blended_path():
    path = np.array([[0, 0], [2, 0], [2, 2]], np.float32)
    smooth = blend_path(path, device=CPU)
    sched = wheel_schedule_along(smooth, v_max=0.7, wheel_base=0.5, device=CPU)
    vl, vr, valid = sched.v_l.numpy(), sched.v_r.numpy(), sched.valid.numpy()
    assert valid.any()
    assert np.nanmax(np.abs(vl)) < 2.0 and np.nanmax(np.abs(vr)) < 2.0
    assert np.abs(vl[valid] - vr[valid]).max() > 0.01
    want = jtr.wheel_schedule_along(smooth, v_max=0.7, wheel_base=0.5)
    np.testing.assert_allclose(vl, np.asarray(want.v_l), atol=ATOL)
    np.testing.assert_allclose(vr, np.asarray(want.v_r), atol=ATOL)


# -- mission scripts -----------------------------------------------------------------

def test_mission_parses_rows_and_config_tags():
    m = Mission.from_rows([(1.0, 2.0), (3.0, 4.0, 0.4, "spin", 1.57, 2)])
    assert len(m.legs) == 2
    assert m.legs[0].action is LegAction.NONE
    assert m.legs[1].speed == 0.4
    assert m.legs[1].action is LegAction.SPIN
    assert m.legs[1].retries == 2
    m2 = Mission.from_config_tags({"Leg1": "1 2 0.5", "Leg2": "3 4 0.3 pause 2.0 0"})
    assert len(m2.legs) == 2 and m2.legs[1].action is LegAction.PAUSE


def runners(rows, **kw):
    """The same mission on the same walled free grid in both packages."""
    jg, tg = grids(free_grid_lo())
    jreached, treached = [], []
    jr = jmission.MissionRunner(jtask.TaskEngine(MODEL, jg, **kw), jmission.Mission.from_rows(rows),
                                on_reached=lambda i, g: jreached.append(i))
    tr = MissionRunner(TaskEngine(TMODEL, tg, device=CPU, **kw), Mission.from_rows(rows),
                       on_reached=lambda i, g: treached.append(i))
    return jr, tr, jreached, treached


def simulate(jr, tr, pose, max_ticks=3000, dt=0.1):
    """Unicycle integration of the port's commands; each tick both runners
    see the same pose and scan."""
    r = open_ranges()
    ticks = 0
    for ticks in range(max_ticks):
        jcmd = jr.tick(pose.copy(), jscan_(r))
        cmd = tr.tick(pose.copy(), tscan(r))
        assert tr.status.value == jr.status.value
        assert tr.engine.state.value == jr.engine.state.value
        held(cmd, jcmd)
        if tr.status in (MissionStatus.DONE, MissionStatus.FAILED):
            break
        v, om = float(cmd.v), float(cmd.omega)
        pose[0] += dt * v * np.cos(pose[2])
        pose[1] += dt * v * np.sin(pose[2])
        pose[2] = (pose[2] + dt * om + np.pi) % (2 * np.pi) - np.pi
    return pose, ticks


def test_mission_runner_runs_multi_leg_with_spin_action():
    jr, tr, jreached, reached = runners([(6.0, 2.0, 0.6, "spin", 1.57), (6.0, 6.0, 0.4)],
                                        goal_tolerance=0.35, robot_radius=0.2)
    for x in (jr, tr):
        x.start()
    pose, ticks = simulate(jr, tr, np.array([2.0, 2.0, 0.0], np.float32))
    assert tr.status is MissionStatus.DONE
    assert reached == [0, 1] == jreached
    assert np.linalg.norm(pose[:2] - [6.0, 6.0]) < 0.6
    assert ticks > 50


def test_mission_runner_retries_then_fails():
    jr, tr, _, _ = runners([(50.0, 50.0, 0.5, "none", 0.0, 2)],
                           goal_tolerance=0.3, robot_radius=0.2)
    for x in (jr, tr):
        x.start()
    pose = np.array([2.0, 2.0, 0.0], np.float32)
    _, ticks = simulate(jr, tr, pose, max_ticks=10)
    assert tr.status is MissionStatus.FAILED
    assert ticks < 9


def test_mission_runner_pause_action_matches_jax():
    jr, tr, _, reached = runners([(4.0, 2.0, 0.5, "pause", 0.5), (4.0, 4.0)],
                                 goal_tolerance=0.35, robot_radius=0.2)
    for x in (jr, tr):
        x.start()
    simulate(jr, tr, np.array([2.0, 2.0, 0.0], np.float32))
    assert tr.status is MissionStatus.DONE and reached == [0, 1]


# -- system monitor --------------------------------------------------------------------

def test_system_monitor_battery_and_link_codes():
    t = [0.0]
    fired = []
    mon = SystemMonitor(ctrl_battery_safe_volt=22.0, link_timeout=1.0,
                        on_error=fired.append, clock=lambda: t[0])
    assert mon.poll() == SYS_OK
    mon.report_battery(24.0, 24.0)
    assert mon.poll() == SYS_OK
    mon.link_alive("sick_a")
    t[0] = 2.5                      # link goes silent past the timeout
    assert mon.poll() == SYS_LOST_CNC_SICK_A
    mon.clear()
    mon.link_alive("sick_a")
    mon.report_battery(20.0, 24.0)  # ctrl battery sags
    assert mon.poll() == SYS_ERR_CTRL_BATTERY_LOW
    assert mon.poll() == SYS_ERR_CTRL_BATTERY_LOW  # latched
    assert fired == [SYS_LOST_CNC_SICK_A, SYS_ERR_CTRL_BATTERY_LOW]


# -- scripted mission through the portal -------------------------------------------------

def test_scripted_mission_via_portal_end_to_end():
    """A multi-leg mission scripted over the portal's MISSION command, with
    REACHED events pushed back and ERR / MAP served."""
    _, tg = grids(free_grid_lo())
    eng = TaskEngine(TMODEL, tg, goal_tolerance=0.35, robot_radius=0.2, device=CPU)
    mon = SystemMonitor()
    runner_box = {}
    portal = NetPortal(
        on_mission=lambda rows: runner_box.update(runner=MissionRunner(
            eng, Mission.from_rows(rows),
            on_reached=lambda i, g: portal.broadcast(f"REACHED {i} {g[0]:.2f} {g[1]:.2f}"))),
        get_error=lambda: (mon.error, "ok"),
        get_map=lambda: (4, 2, 0.1, bytes(range(8))),
    )
    portal.start()
    try:
        c = socket.create_connection(("127.0.0.1", portal.port), timeout=2)
        f = c.makefile("rw", encoding="utf-8", newline="\n")
        f.write("MISSION 6 2 0.6 spin 1.57 ; 6 6 0.4\n")
        f.flush()
        assert f.readline().strip() == "OK"
        runner = runner_box["runner"]
        runner.start()
        pose = np.array([2.0, 2.0, 0.0], np.float32)
        r = tscan(open_ranges())
        for _ in range(3000):
            cmd = runner.tick(pose, r)
            if runner.status in (MissionStatus.DONE, MissionStatus.FAILED):
                break
            v, om = float(cmd.v), float(cmd.omega)
            pose[0] += 0.1 * v * np.cos(pose[2])
            pose[1] += 0.1 * v * np.sin(pose[2])
            pose[2] = (pose[2] + 0.1 * om + np.pi) % (2 * np.pi) - np.pi
        assert runner.status is MissionStatus.DONE
        c.settimeout(2)
        events = [f.readline().strip(), f.readline().strip()]
        assert events[0].startswith("EVENT REACHED 0")
        assert events[1].startswith("EVENT REACHED 1")
        f.write("ERR\n")
        f.flush()
        assert f.readline().strip() == "ERR 0 ok"
        f.write("MAP\n")
        f.flush()
        parts = f.readline().strip().split()
        assert parts[0] == "MAP" and parts[1] == "4" and parts[2] == "2"
        assert zlib.decompress(base64.b64decode(parts[4])) == bytes(range(8))
    finally:
        portal.stop()
