"""Robot composition root: config + SLAM + tasks + portal + logging.

The role of the reference's ``C_C`` (src/Main-Ctrl/C_C.{h,cpp}): parse
the config, bring up the SLAM facade, the task engine, the remote
portal, and the logger, and pump sensor data between them. The
reference wires pthreads and serial ports; here the composition is a
plain object the host application ticks — sensors push in, motor
commands come out of :meth:`control_tick`.

Port of ``app/robot.py``: the SLAM facade, the ambient local map and the
task engine run on ``device`` (``cuda`` unless the caller names another;
construction raises where there is no CUDA device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.scan import LaserModel
from ..mapping.occupancy import OccupancyGrid
from ..nav.controller import ControlCommand
from ..nav.local_map import LocalMapService
from ..runtime.facade import SlamCallbacks, SlamV1
from .config import RobotConfig, load_config
from .logfile import LOG_IOA, LOG_NET, LOG_SLAM, LOG_TASK, LogFile
from .mission import Mission, MissionRunner, MissionStatus
from .monitor import (
    ERROR_NAMES, SYS_ERR_CTRL_BATTERY_LOW, SYS_ERR_POWER_BATTERY_LOW,
    SystemMonitor,
)
from .portal import NetPortal
from .task import TaskEngine, TaskState


@dataclasses.dataclass
class RobotController:
    """``C_C`` analog: one object owning the full robot stack."""

    model: LaserModel
    config: RobotConfig = dataclasses.field(default_factory=RobotConfig)
    work_mode: str = "mapping"
    localization_grid: OccupancyGrid | None = None
    enable_portal: bool = False
    device: torch.device | str | None = None

    @classmethod
    def from_config_file(cls, model: LaserModel, path: str, **kw) -> "RobotController":
        return cls(model, config=load_config(path), **kw)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.log = LogFile(self.config.log_file)
        self.slam = SlamV1(
            self.model,
            callbacks=SlamCallbacks(
                on_error=lambda c: self.log.log(LOG_SLAM, f"error code {c}"),
            ),
            work_mode=self.work_mode,
            localization_grid=self.localization_grid,
            device=self.device,
        )
        self.slam.start()
        self.tasks: TaskEngine | None = None
        if self.localization_grid is not None:
            self.tasks = TaskEngine(self.model, self.localization_grid, device=self.device)
        self.portal: NetPortal | None = None
        if self.enable_portal:
            self.portal = NetPortal(
                host=self.config.control.ip or "127.0.0.1",
                port=self.config.control.port,
                on_goto=self._goto,
                on_cancel=lambda: self.tasks and self.tasks.cancel(),
                get_pose=lambda: tuple(float(v) for v in self.slam.pose),
                get_state=lambda: (
                    self.tasks.state.value if self.tasks else "no-tasks"
                ),
                on_path=lambda pts: self.tasks and self.tasks.add_path(pts),
                on_repath=lambda pts: (
                    self.tasks and self.tasks.replace_path(pts)
                ),
                on_slow_stop=lambda: self.tasks and self.tasks.slow_stop(),
                # A silent console stops the robot (HEART_BIT supervision).
                on_heartbeat_lost=lambda: (
                    self.tasks and self.tasks.slow_stop()
                ),
                on_mission=self._start_mission,
                get_error=lambda: (
                    self.monitor.error, ERROR_NAMES[self.monitor.error]
                ),
                get_map=self._map_fetch,
            )
            self.portal.start()
            self.log.log(LOG_NET, f"portal listening on {self.portal.port}")
        # ambient map around the robot (MapService/AmbientGridMap role)
        self.local_map = LocalMapService(self.model, device=self.device)
        self._last_scan = None
        # System health: battery + link supervision driving the task
        # engine (ThreadSystemMonitor + ErrList, C_C.cpp:930-961).
        self.monitor = SystemMonitor(on_error=self._on_sys_error)
        self.mission_runner: MissionRunner | None = None

    # -- health -----------------------------------------------------------

    def _on_sys_error(self, code: int) -> None:
        self.log.log(LOG_IOA, f"system error {code} ({ERROR_NAMES[code]})")
        if self.portal is not None:
            self.portal.broadcast(f"ERROR {code} {ERROR_NAMES[code]}")
        if self.tasks is None:
            return
        if code in (SYS_ERR_CTRL_BATTERY_LOW, SYS_ERR_POWER_BATTERY_LOW):
            # Battery sag: controlled deceleration, keep localization up.
            self.tasks.slow_stop()
        else:
            # A lost sensor/chassis link makes motion unsafe NOW.
            self.tasks.cancel()

    def _start_mission(self, rows) -> None:
        if self.tasks is None:
            self.log.log(LOG_TASK, "mission rejected: no task engine")
            return
        runner = MissionRunner(
            self.tasks, Mission.from_rows(rows),
            on_reached=lambda i, g: (
                self.log.log(LOG_TASK, f"leg {i} reached {g}"),
                self.portal and self.portal.broadcast(
                    f"REACHED {i} {g[0]:.2f} {g[1]:.2f}"
                ),
            ),
        )
        self.mission_runner = runner
        runner.start()
        self.log.log(LOG_TASK, f"mission started: {len(rows)} legs")

    def _map_fetch(self):
        """Occupancy fetch for the portal's MAP command: the ambient
        grid as (w, h, resolution, byte cells 0..255 occupancy)."""
        lmap = self.local_map.map
        prob = lmap.probability().cpu().numpy()
        cells = np.clip(prob * 255.0, 0, 255).astype(np.uint8)
        h, w = cells.shape
        return w, h, float(lmap.resolution), cells.tobytes()

    # -- sensor pumps ------------------------------------------------------

    def on_scan_main(self, ranges) -> np.ndarray | None:
        self._last_scan = np.asarray(ranges, np.float32)
        pose = self.slam.feed_scan_main(self._last_scan)
        if pose is not None:
            # Reuse the scan the SLAM pipeline already preprocessed on
            # device rather than filtering + uploading a second time.
            scan = self.slam.last_scan
            if scan is None:
                scan = self.slam._preprocess_one(self._last_scan)
            self.local_map.stream_in(scan, np.asarray(pose, np.float32))
        return pose

    def on_scan_minor(self, ranges) -> None:
        self.slam.feed_scan_minor(ranges)

    def on_odometry(self, x: float, y: float, theta: float) -> None:
        self.slam.feed_odometry(x, y, theta)

    def on_beacon(self, x: float, y: float, theta: float = 0.0) -> None:
        self.slam.feed_beacon(x, y, theta)

    # -- mission / control ---------------------------------------------------

    def _goto(self, x: float, y: float) -> None:
        if self.tasks is None:
            self.log.log(LOG_TASK, "goto rejected: no task engine (no grid)")
            return
        self.tasks.add_goal((x, y))
        self.log.log(LOG_TASK, f"goal queued ({x:.2f}, {y:.2f})")

    def control_tick(self) -> ControlCommand | None:
        """Compute the current motor command from pose + latest scan.
        Health is polled first: a latched system error has already
        stopped/cancelled the mission via :meth:`_on_sys_error`."""
        if self.tasks is None or self._last_scan is None:
            return None
        self.monitor.poll()
        scan = self.slam._preprocess_one(self._last_scan)
        if (
            self.mission_runner is not None
            and self.mission_runner.status in (
                MissionStatus.RUNNING, MissionStatus.ACTION
            )
        ):
            cmd = self.mission_runner.tick(self.slam.pose, scan)
        else:
            cmd = self.tasks.step(self.slam.pose, scan)
        if self.tasks.state in (TaskState.BLOCKED, TaskState.FAILED):
            self.log.log(LOG_IOA, f"task state {self.tasks.state.value}")
        return cmd

    def shutdown(self) -> None:
        if self.portal is not None:
            self.portal.stop()
        self.slam.stop()
        self.log.close()
