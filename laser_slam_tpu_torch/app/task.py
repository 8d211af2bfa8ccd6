"""Waypoint task engine: goal queue + plan + track + replan-on-block
(port of ``app/task.py``).

Accept goals, plan a grid path, track it with pure pursuit under the
obstacle-avoidance speed caps, dodge or replan when blocked, report
completion. The per-tick compute (plan, control, dodge) runs on the
engine's device; only the small state machine lives on the host. A tick
reads the command's zone back (one fetch); a plan reads its path,
``n_valid`` and ``reached`` back after the descent (one fetch).
"""

from __future__ import annotations

import dataclasses
import enum
import threading
from collections import deque

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.scan import LaserModel, Scan
from ..mapping.occupancy import OccupancyGrid
from ..nav.controller import ControlCommand, track_step
from ..nav.local_planner import dodge_path
from ..nav.planner import plan_path


def command(v: float, omega: float, device) -> ControlCommand:
    """A motor command with no active zone, made on ``device`` (filled
    there: no upload)."""
    return ControlCommand(
        v=torch.full((), v, dtype=torch.float32, device=device),
        omega=torch.full((), omega, dtype=torch.float32, device=device),
        zone=torch.full((), -1, dtype=torch.int32, device=device),
    )


class TaskState(enum.Enum):
    IDLE = "idle"
    PLANNING = "planning"
    TURNING = "turning"     # in-place face-to-milestone before tracking
    TRACKING = "tracking"
    DODGING = "dodging"     # following a local milestone dodge path
    BLOCKED = "blocked"
    STOPPING = "stopping"   # slow-stop ramp (SLOW_BREAK)
    DONE = "done"
    FAILED = "failed"


@dataclasses.dataclass
class TaskEngine:
    """Host-side mission state machine over the plan / track / dodge
    functions, which run on ``device``: ``cuda`` unless the caller names
    another (construction raises where there is no CUDA device). The
    grid is moved there."""

    model: LaserModel
    grid: OccupancyGrid
    robot_radius: float = 0.3
    goal_tolerance: float = 0.25          # [m]
    v_des: float = 0.8                    # [m/s]
    blocked_ticks_replan: int = 5         # zone-0 ticks before replanning
    max_replans: int = 3
    face_tolerance: float = 0.6           # [rad] turn in place beyond this
    turn_rate: float = 0.8                # [rad/s] in-place turn
    stop_decel_ticks: int = 10            # slow-stop ramp length
    use_local_dodge: bool = True          # milestone dodge before replan
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.grid = OccupancyGrid(self.grid.log_odds.to(self.device), self.grid.spec)
        self.state = TaskState.IDLE
        # Guards mission state against portal/watchdog threads: their
        # handlers mutate _goals/_path concurrently with the control
        # thread's step(); an unsynchronized clear landing between step()'s
        # state check and its _goals[0] read raises IndexError and kills
        # the control loop. Reentrant because replace_path → add_path →
        # add_goal all take it.
        self._lock = threading.RLock()
        self._goals: deque[np.ndarray] = deque()
        self._speed_limits: deque[float] = deque()  # per-leg caps
        self._path: np.ndarray | None = None
        self._path_dev: torch.Tensor | None = None   # the same, on the device
        self._n_valid = 0
        self._blocked = 0
        self._replans = 0
        self._stop_tick = 0
        self._leg_v = self.v_des
        self.n_plans = 0
        self.n_dodges = 0

    # -- mission API ------------------------------------------------------

    def add_goal(self, xy, speed_limit: float | None = None) -> None:
        with self._lock:
            self._add_goal_locked(xy, speed_limit)

    def _add_goal_locked(self, xy, speed_limit: float | None = None) -> None:
        self._goals.append(np.asarray(xy, np.float32))
        self._speed_limits.append(
            self.v_des if speed_limit is None else float(speed_limit)
        )
        if self.state in (TaskState.IDLE, TaskState.DONE):
            self.state = TaskState.PLANNING

    def add_path(self, points, speed_limits=None) -> None:
        """Queue a multi-waypoint task path with optional per-leg speed
        caps (the NEW_TASK_PATH command)."""
        points = np.asarray(points, np.float32).reshape(-1, 2)
        if speed_limits is None:
            speed_limits = [None] * len(points)
        for p, s in zip(points, speed_limits):
            self.add_goal(p, s)

    def replace_path(self, points, speed_limits=None) -> None:
        """Replace the current mission with a new path mid-run (the
        RE_TASK_PATH command: freeze, clear, reload)."""
        with self._lock:
            self._goals.clear()
            self._speed_limits.clear()
            self._set_path(None)
            self.state = TaskState.IDLE
            self.add_path(points, speed_limits)

    def slow_stop(self) -> None:
        """Decelerate to a stop over ``stop_decel_ticks`` and clear the
        mission (the SLOW_BREAK command)."""
        with self._lock:
            self._goals.clear()
            self._speed_limits.clear()
            self._set_path(None)
            self._stop_tick = self.stop_decel_ticks
            self.state = TaskState.STOPPING

    def cancel(self) -> None:
        with self._lock:
            self._goals.clear()
            self._speed_limits.clear()
            self._set_path(None)
            self.state = TaskState.IDLE

    def velocity_schedule(self):
        """Feed-forward wheel-speed schedule for the current planned path
        (the open-loop profile for lower-level controllers; live control
        uses :meth:`step`). Returns a :class:`..nav.trajectory.Schedule` on
        the engine's device, or None when no path is planned."""
        from ..nav.trajectory import plan_velocity_schedule

        with self._lock:
            if self._path is None:
                return None
            pts = self._path[: self._n_valid]
            leg_v = self._leg_v
        return plan_velocity_schedule(pts, v_max=leg_v, device=self.device)

    def update_grid(self, grid: OccupancyGrid) -> None:
        """Swap in a fresher map (the SLAM global map)."""
        self.grid = OccupancyGrid(grid.log_odds.to(self.device), grid.spec)

    # -- control tick -----------------------------------------------------

    def step(self, pose, scan: Scan) -> ControlCommand:
        """One control tick; returns the motor command (v=0 when idle).
        Holds the mission lock for the whole tick so portal commands
        apply atomically between ticks, never inside one."""
        with self._lock:
            return self._step_locked(pose, scan)

    def _command(self, v: float = 0.0, omega: float = 0.0) -> ControlCommand:
        return command(v, omega, self.device)

    def _set_path(self, path: np.ndarray | None, path_dev: torch.Tensor | None = None) -> None:
        self._path = path
        if path is None:
            self._path_dev = None
        else:
            self._path_dev = path_dev if path_dev is not None else \
                torch.from_numpy(path).to(self.device)

    def _plan(self, start_xy, goal_xy):
        """The grid plan on the device, then its path, ``n_valid`` and
        ``reached`` in one fetch."""
        dev = self.device
        res = plan_path(self.grid, torch.from_numpy(start_xy).to(dev),
                        torch.from_numpy(goal_xy).to(dev), robot_radius=self.robot_radius)
        self.n_plans += 1
        out = torch.cat([res.path.reshape(-1),
                         torch.stack([res.n_valid.to(torch.float32),
                                      res.reached.to(torch.float32)])]).cpu().numpy()
        return res.path, out[:-2].reshape(-1, 2), int(out[-2]), bool(out[-1])

    def _step_locked(self, pose, scan: Scan) -> ControlCommand:
        pose = np.asarray(pose, np.float32)
        stop = self._command()

        if self.state == TaskState.STOPPING:
            # Linear deceleration ramp (Stop-Robot-Slowly semantics).
            self._stop_tick -= 1
            if self._stop_tick <= 0:
                # Goals queued during the ramp start their mission once the
                # ramp completes.
                self.state = (
                    TaskState.PLANNING if self._goals else TaskState.IDLE
                )
                return stop
            frac = self._stop_tick / self.stop_decel_ticks
            return self._command(v=self._leg_v * frac)

        if self.state == TaskState.PLANNING:
            if not self._goals:
                self.state = TaskState.IDLE
                return stop
            goal = self._goals[0]
            path_dev, path, n_valid, reached = self._plan(pose[:2].copy(), goal)
            if not reached:
                self.state = TaskState.FAILED
                return stop
            self._set_path(path, path_dev)
            self._n_valid = n_valid
            self._leg_v = self._speed_limits[0] if self._speed_limits else (
                self.v_des
            )
            self._blocked = 0
            # Face the first leg before driving: turn in place toward the
            # milestone when the heading is far off (FaceToMilestone).
            tgt = self._path[min(2, self._n_valid - 1)]
            err = self._heading_error(pose, tgt)
            self.state = (
                TaskState.TURNING if abs(err) > self.face_tolerance
                else TaskState.TRACKING
            )

        if self.state == TaskState.TURNING:
            tgt = self._path[min(2, self._n_valid - 1)]
            err = self._heading_error(pose, tgt)
            if abs(err) > 0.15:
                return self._command(omega=float(np.float32(np.sign(err) * self.turn_rate)))
            self.state = TaskState.TRACKING

        if self.state not in (TaskState.TRACKING, TaskState.DODGING):
            return stop

        goal = self._goals[0]
        if np.linalg.norm(pose[:2] - goal) < self.goal_tolerance:
            self._goals.popleft()
            if self._speed_limits:
                self._speed_limits.popleft()
            self._set_path(None)
            if self._goals:
                self.state = TaskState.PLANNING
                return self.step(pose, scan)  # plan the next leg this tick
            self.state = TaskState.DONE
            return stop

        if self.state == TaskState.DODGING:
            # Dodge leg complete when its last waypoint is reached; then
            # return to the original path via a fresh plan (Back2OriPath).
            end = self._path[self._n_valid - 1]
            if np.linalg.norm(pose[:2] - end) < self.goal_tolerance:
                self.state = TaskState.PLANNING
                return self.step(pose, scan)

        scan = Scan(*(x.to(self.device) for x in scan))
        cmd = track_step(self.model, scan, torch.from_numpy(pose).to(self.device),
                         self._path_dev, self._n_valid, v_des=self.v_des)
        cmd = cmd._replace(v=torch.clamp(cmd.v, max=self._leg_v))
        # Innermost security zone -> stopped by the speed cap; count and
        # escalate around the obstruction: first a local milestone dodge,
        # then a full replan.
        if int(cmd.zone) == 0:
            self._blocked += 1
            if self._blocked >= self.blocked_ticks_replan:
                self._replans += 1
                if self._replans > self.max_replans:
                    self.state = TaskState.FAILED
                elif self.use_local_dodge and self.state == TaskState.TRACKING:
                    if not self._try_dodge(pose, scan):
                        self.state = TaskState.PLANNING
                else:
                    self.state = TaskState.PLANNING
                self._blocked = 0
                return stop
        else:
            self._blocked = 0
        return cmd

    def _heading_error(self, pose, tgt_xy) -> float:
        des = float(np.arctan2(tgt_xy[1] - pose[1], tgt_xy[0] - pose[0]))
        return float(
            (des - pose[2] + np.pi) % (2.0 * np.pi) - np.pi
        )

    def _try_dodge(self, pose, scan: Scan) -> bool:
        """Local milestone dodge from the live scan (seed-grow + milestone
        selection, :mod:`..nav.local_planner`). Returns True when a dodge
        path was adopted."""
        ms = dodge_path(self.model, scan)
        self.n_dodges += 1
        out = torch.cat([ms.path_xy.reshape(-1), ms.ok[None].to(torch.float32)]).cpu().numpy()
        if not out[-1]:
            return False
        # Robot-frame waypoints → world frame (local x forward, y left).
        c, s = np.cos(pose[2]), np.sin(pose[2])
        local = out[:-1].reshape(-1, 2)
        world = np.stack(
            [
                pose[0] + c * local[:, 0] - s * local[:, 1],
                pose[1] + s * local[:, 0] + c * local[:, 1],
            ],
            axis=-1,
        ).astype(np.float32)
        self._set_path(world)
        self._n_valid = world.shape[0]
        self.state = TaskState.DODGING
        return True
