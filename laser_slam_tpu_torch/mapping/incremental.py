"""Incremental occupancy mapping for online sessions (port of
``mapping/incremental.py``).

A live grid that every new scan updates and that local windows are
cropped from:

- ``add`` fuses one scan into the persistent grid on the session's
  device (two ``index_add_`` calls at fixed shapes);
- ``rebase`` re-integrates the history only when the backend's optimized
  poses actually moved (the ``bigChange`` gate), so the cost per scan
  stays flat: loop closures are rare;
- ``local_crop`` copies an egocentric window out of the grid, with no
  rebuild.

On a CUDA device ``index_add_`` sums with float atomics, so the
log-odds of two sessions over the same scans agree in the hit counts and
differ in the last bits of cells that several samples of one scan reach.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.scan import LaserModel, Scan, stack_scans
from .occupancy import GridSpec2D, OccupancyGrid, empty_grid, integrate_scans

Tensor = torch.Tensor

# Rebase when any historical pose moved more than this (pose updates are
# broadcast only on a "big change").
REBASE_TRANSLATION = 0.25   # [m]
REBASE_ROTATION = 0.05      # [rad]


@dataclasses.dataclass
class IncrementalMapper:
    """Persistent log-odds grid updated scan by scan.

    The grid extent is fixed at construction (``center`` ± ``half_size``):
    online sessions know their arena; offline rendering with unknown
    extent keeps using ``spec_for_trajectory`` + ``integrate_scans``. The
    grid lives on ``device``: ``cuda`` unless the caller names another
    (and then construction raises where there is no CUDA device).
    """

    model: LaserModel
    resolution: float = 0.1
    half_size: float = 60.0
    center: tuple[float, float] = (0.0, 0.0)
    keep_history: bool = True
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        n = int(round(2 * self.half_size / self.resolution))
        self.spec = GridSpec2D(
            origin_x=self.center[0] - self.half_size,
            origin_y=self.center[1] - self.half_size,
            resolution=self.resolution,
            width=n,
            height=n,
        )
        self.grid: OccupancyGrid = empty_grid(self.spec, device=self.device)
        self._scans: list[Scan] = []
        self._poses: list[np.ndarray] = []

    # -- O(1) per-scan path ------------------------------------------------

    def add(self, scan: Scan, pose) -> None:
        """Fuse one preprocessed scan ``[N]`` posed at ``pose [3]``."""
        if isinstance(pose, Tensor):
            pose = pose.detach().cpu().numpy()
        pose = np.array(pose, np.float32)
        self.grid = integrate_scans(
            self.grid, self.model, Scan(*(x[None] for x in scan)),
            torch.from_numpy(pose).to(self.device)[None])
        if self.keep_history:
            self._scans.append(scan)
            self._poses.append(pose)

    def covers(self, poses: np.ndarray, margin: float = 0.0) -> bool:
        """True iff every pose lies inside the fixed arena; callers
        rebuild at full extent otherwise (beams beyond the arena edge are
        clipped by design; a pose outside it means the map is genuinely
        truncated)."""
        if len(poses) == 0:
            return True
        spec = self.spec
        xy = np.asarray(poses)[:, :2]
        return bool(
            (xy[:, 0] - margin >= spec.origin_x).all()
            and (xy[:, 1] - margin >= spec.origin_y).all()
            and (xy[:, 0] + margin <= spec.origin_x + spec.width * spec.resolution).all()
            and (xy[:, 1] + margin <= spec.origin_y + spec.height * spec.resolution).all()
        )

    # -- rebase on loop closure ---------------------------------------------

    def needs_rebase(self, new_poses: np.ndarray) -> bool:
        """True iff optimized poses moved beyond the bigChange gate."""
        if not self._poses:
            return False
        old = np.stack(self._poses)
        new = np.asarray(new_poses)[: len(old)]
        dt = np.linalg.norm(new[:, :2] - old[: len(new), :2], axis=-1)
        dr = np.abs(
            (new[:, 2] - old[: len(new), 2] + np.pi) % (2 * np.pi) - np.pi
        )
        return bool((dt > REBASE_TRANSLATION).any() or
                    (dr > REBASE_ROTATION).any())

    def rebase(self, new_poses: np.ndarray) -> None:
        """Re-integrate the history under corrected poses (rare; call
        only when :meth:`needs_rebase`)."""
        if not self.keep_history or not self._scans:
            return
        n = min(len(self._scans), len(new_poses))
        poses = torch.as_tensor(np.asarray(new_poses)[:n], dtype=torch.float32).to(self.device)
        self.grid = integrate_scans(
            empty_grid(self.spec, device=self.device), self.model,
            stack_scans(self._scans[:n]), poses,
        )
        self._poses = [np.asarray(p, np.float32) for p in new_poses[:n]] + \
            self._poses[n:]

    # -- egocentric window ----------------------------------------------------

    def local_crop(self, pose, half_cells: int = 64) -> tuple[Tensor, GridSpec2D]:
        """``[2H, 2H]`` log-odds window centered on ``pose`` (host
        numbers), and its own GridSpec (axis-aligned, not rotated). The
        window is a copy: it does not change when the grid does."""
        spec = self.spec
        cx = int((float(pose[0]) - spec.origin_x) / spec.resolution)
        cy = int((float(pose[1]) - spec.origin_y) / spec.resolution)
        size = 2 * half_cells
        y0 = int(np.clip(cy - half_cells, 0, spec.height - size))
        x0 = int(np.clip(cx - half_cells, 0, spec.width - size))
        win = self.grid.log_odds[y0:y0 + size, x0:x0 + size].clone()
        wspec = GridSpec2D(
            origin_x=spec.origin_x + x0 * spec.resolution,
            origin_y=spec.origin_y + y0 * spec.resolution,
            resolution=spec.resolution,
            width=size,
            height=size,
        )
        return win, wspec
