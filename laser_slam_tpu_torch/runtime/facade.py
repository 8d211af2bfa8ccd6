"""Deployable SLAM facade with a callback surface (port of
``runtime/facade.py``).

The robot application hands over a callback table, pushes sensor
readings (two lasers, odometry, beacon, GPS), and receives fused poses,
localization results, obstacle-detection speed caps, maps, and system
error codes through those callbacks:

==============================  =========================================
input / output                   here
==============================  =========================================
wheel odometry, beacon fix       ``feed_odometry`` / ``feed_beacon``
main laser                       ``feed_scan_main`` (SLAM + obstacle)
minor laser                      ``feed_scan_minor`` (obstacle only)
raw laser frames                 ``on_scan_a`` / ``on_scan_b``
fused pose                       ``on_fused_pose``
local / global map               ``on_local_map`` / ``on_global_map``
error list                       ``on_error`` (codes below)
SLAM-only pose                   ``on_slam_pose``
odometry-only pose               ``on_odo_pose``
beacon-only pose                 ``on_beacon_pose``
fused pose and point cloud       ``on_pose_and_cloud``
localization result              ``on_localization``
==============================  =========================================

Work modes: ``"mapping"`` runs the online SLAM pipeline;
``"localization"`` runs the particle filter against a prebuilt occupancy
grid.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core import se2
from ..core.device import resolve_device
from ..core.scan import LaserModel, Scan
from ..localization import particle_filter as pf
from ..localization.raycast import likelihood_field
from ..mapping.occupancy import OccupancyGrid
from ..nav.controller import security_speed_cap
from ..ops.preprocess import preprocess
from .online import OnlineSlam
from .slam import SlamConfig

# System error codes.
SYS_ERR_CTRL_BATTERY_LOW = 1
SYS_ERR_POWER_BATTERY_LOW = 2
SYS_LOST_CNC_SICK_A = 3
SYS_LOST_CNC_SICK_B = 4
SYS_LOST_BN_SERIAL = 5
SYS_LOST_LOW_CTRL_SERIAL = 6


@dataclasses.dataclass
class SlamCallbacks:
    """Optional observers; any subset may be set."""

    on_fused_pose: Callable[[np.ndarray], None] | None = None
    on_slam_pose: Callable[[np.ndarray], None] | None = None
    on_odo_pose: Callable[[np.ndarray], None] | None = None
    on_beacon_pose: Callable[[np.ndarray], None] | None = None
    on_localization: Callable[[np.ndarray], None] | None = None
    on_pose_and_cloud: Callable[[np.ndarray, np.ndarray], None] | None = None
    on_scan_a: Callable[[np.ndarray], None] | None = None
    on_scan_b: Callable[[np.ndarray], None] | None = None
    on_local_map: Callable[[np.ndarray], None] | None = None
    on_global_map: Callable[[OccupancyGrid], None] | None = None
    on_obstacle: Callable[[float, int], None] | None = None
    on_error: Callable[[int], None] | None = None


@dataclasses.dataclass
class SlamV1:
    """Deployable facade: one object, push sensors in, callbacks out.

    ``work_mode``: ``"mapping"`` (online SLAM) or ``"localization"``
    (particle filter against ``localization_grid``, weighted by the
    ``observation_model``: ``"field"``, the likelihood field,
    ``"beam"``, the ray-cast beam model, or ``"icp"``, ray-cast + ICP).
    The first scan relocalizes globally from samples over the map's free
    space: in ``"icp"`` mode scored by ray-cast + ICP, the reference's
    own ``globalization``, which is that scan's update (no likelihood
    field is built); otherwise scored on the field, then weighted by the
    model. Everything runs on ``device``: ``cuda`` unless the caller names
    another, and then construction raises where there is no CUDA device.
    The particle filter draws from a ``torch.Generator`` on that device,
    seeded with ``seed``.
    """

    model: LaserModel
    callbacks: SlamCallbacks = dataclasses.field(default_factory=SlamCallbacks)
    work_mode: str = "mapping"
    cfg: SlamConfig = SlamConfig()
    localization_grid: OccupancyGrid | None = None
    observation_model: str = "field"   # localization: "field", "beam" or "icp"
    n_particles: int = 1024
    local_map_radius: float = 5.0
    seed: int = 0
    async_backend: bool = True  # the deployable surface overlaps
    #                             frontend and backend by default; scan
    #                             feeds never wait for a backend round
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._running = False
        self._odo_pose = np.zeros(3, np.float32)
        self._last_odo = None
        self._beacon_pose: np.ndarray | None = None
        self._slam: OnlineSlam | None = None
        self._pf_state: pf.ParticleState | None = None
        self._field = None
        self._free = None
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(self.seed)
        self._pending_rel = np.zeros(3, np.float32)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self.work_mode == "mapping":
            self._slam = OnlineSlam(
                self.model, cfg=self.cfg,
                on_pose=self.callbacks.on_slam_pose, use_fusion=True,
                async_backend=self.async_backend, device=self.device,
            )
        elif self.work_mode == "localization":
            if self.localization_grid is None:
                raise ValueError("localization mode needs localization_grid")
            if self.observation_model not in pf.OBSERVATION_MODELS:
                raise ValueError(f"unknown observation_model {self.observation_model!r}")
            grid = self.localization_grid
            self.localization_grid = OccupancyGrid(grid.log_odds.to(self.device), grid.spec)
            self._free = pf.free_cells(self.localization_grid)
            if self.observation_model != "icp":
                self._field = likelihood_field(self.localization_grid)
        else:
            raise ValueError(f"unknown work_mode {self.work_mode!r}")
        self._running = True

    def stop(self) -> None:
        # Drain the in-flight/pending async backend rounds before the
        # lights go out; skip the final full-session round: stop() is a
        # lifecycle call, not a map-finalization request. A round that
        # failed on its worker raises here.
        try:
            if self._slam is not None:
                self._slam.flush(final_round=False)
        finally:
            self._running = False

    # -- sensor inputs ----------------------------------------------------

    def feed_odometry(self, x: float, y: float, theta: float) -> None:
        """Wheel odometry pose. Accumulates the relative motion used as
        the PF predict / frontend prior."""
        new = np.asarray([x, y, theta], np.float32)
        if self._last_odo is not None:
            rel = se2.np_relative(self._last_odo, new).astype(np.float32)
            self._pending_rel = se2.np_compose(self._pending_rel, rel).astype(np.float32)
        self._last_odo = new
        self._odo_pose = new
        if self.callbacks.on_odo_pose:
            self.callbacks.on_odo_pose(new)

    def feed_beacon(self, x: float, y: float, theta: float) -> None:
        """Beacon triangulation fix."""
        self._beacon_pose = np.asarray([x, y, theta], np.float32)
        if self._slam is not None:
            self._slam.feed_beacon(self._beacon_pose[:2])
        if self.callbacks.on_beacon_pose:
            self.callbacks.on_beacon_pose(self._beacon_pose)

    def feed_gps(self, obs) -> None:
        """GPS fix: an object with ``east``, ``north``, ``t``, or an
        ``(east, north)`` pair; it goes to the filter's position observe."""
        if self._slam is not None:
            self._slam.feed_gps(obs)

    def feed_scan_main(self, ranges, timestamp: float = 0.0) -> np.ndarray | None:
        """Main laser frame: drives SLAM/localization *and* obstacle
        detection."""
        if not self._running:
            return None
        ranges = np.asarray(ranges, np.float32)
        if self.callbacks.on_scan_a:
            self.callbacks.on_scan_a(ranges)
        self._obstacle_check(ranges)

        if self.work_mode == "mapping":
            self._slam.feed_scan(ranges)
            fused = self._slam.pose
            if self.callbacks.on_fused_pose:
                self.callbacks.on_fused_pose(fused)
            if self.callbacks.on_pose_and_cloud:
                self.callbacks.on_pose_and_cloud(fused, ranges)
            self._emit_local_map(fused)
            return fused

        return self._localize_step(ranges)

    def feed_scan_minor(self, ranges, timestamp: float = 0.0) -> None:
        """Second laser: obstacle detection only."""
        ranges = np.asarray(ranges, np.float32)
        if self.callbacks.on_scan_b:
            self.callbacks.on_scan_b(ranges)
        self._obstacle_check(ranges)

    def report_error(self, code: int) -> None:
        """Hardware/system error entry point (laser reconnects, battery
        and serial codes)."""
        if self.callbacks.on_error:
            self.callbacks.on_error(int(code))

    # -- outputs ----------------------------------------------------------

    @property
    def pose(self) -> np.ndarray:
        if self.work_mode == "mapping" and self._slam is not None:
            return self._slam.pose
        if self._pf_state is not None:
            return pf.estimate(self._pf_state).cpu().numpy()
        return self._odo_pose

    @property
    def last_scan(self):
        """The most recent preprocessed :class:`Scan` (on the device), for
        consumers that would otherwise re-run preprocess on the hot sensor
        path (local map, obstacle layer)."""
        if self._slam is not None:
            return self._slam.last_scan
        return None

    def global_map(self, resolution: float = 0.05) -> OccupancyGrid:
        if self._slam is None:
            raise RuntimeError("global map only available in mapping mode")
        grid = self._slam.render_map(resolution)
        if self.callbacks.on_global_map:
            self.callbacks.on_global_map(grid)
        return grid

    # -- internals --------------------------------------------------------

    def _preprocess_one(self, ranges: np.ndarray) -> Scan:
        batch = preprocess(torch.from_numpy(ranges).to(self.device)[None, :], self.model)
        return Scan(*(x[0] for x in batch))

    def _obstacle_check(self, ranges: np.ndarray) -> None:
        if self.callbacks.on_obstacle is None:
            return
        speed, zone = security_speed_cap(self.model, self._preprocess_one(ranges))
        # Both numbers in one fetch.
        out = torch.stack([speed, zone.to(speed.dtype)]).cpu().numpy()
        self.callbacks.on_obstacle(float(out[0]), int(out[1]))

    def _localize_step(self, ranges: np.ndarray) -> np.ndarray:
        scan = self._preprocess_one(ranges)
        valid = ~scan.bad
        if self._pf_state is None:
            # Global relocalization on the first scan.
            self._pf_state = pf.relocalize_and_weigh(
                self._generator, self.observation_model, self.localization_grid, self._field,
                self.model, scan.ranges, valid, self.n_particles, self._free,
            )
        else:
            rel = torch.from_numpy(self._pending_rel).to(self.device)
            self._pf_state = pf.predict(self._pf_state, rel, self._generator)
            self._pending_rel = np.zeros(3, np.float32)
            self._pf_state = pf.weigh(
                self.observation_model, self._pf_state, self.localization_grid, self._field,
                self.model, scan.ranges, valid,
            )
        self._pf_state = pf.maybe_resample(self._pf_state, self._generator)
        est = pf.estimate(self._pf_state).cpu().numpy()
        if self.callbacks.on_localization:
            self.callbacks.on_localization(est)
        if self.callbacks.on_fused_pose:
            self.callbacks.on_fused_pose(est)
        return est

    def _emit_local_map(self, pose: np.ndarray) -> None:
        """Egocentric occupancy patch around the robot (the robot app's
        obstacle-avoidance input). O(1) per scan: a window of the live
        incremental grid, never a map rebuild."""
        if self.callbacks.on_local_map is None or self._slam is None:
            return
        half_cells = max(
            int(self.local_map_radius / self._slam.map_resolution), 1
        )
        win, _ = self._slam.local_map(pose, half_cells)
        self.callbacks.on_local_map(torch.sigmoid(win).cpu().numpy())
