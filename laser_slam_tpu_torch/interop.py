"""State carried between this port and ``laser_slam_tpu``.

The system has no weights; its state is the laser model, scans, poses
and grids. These helpers move them through plain python / numpy, so
neither package imports the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.scan import LaserModel, Scan
from .mapping.occupancy import GridSpec2D, OccupancyGrid


def model_from_fields(d: dict) -> LaserModel:
    """A port :class:`LaserModel` from the field dict of a JAX
    ``LaserModel`` (``dataclasses.asdict``)."""
    return LaserModel(**d)


def model_to_fields(model: LaserModel) -> dict:
    return dataclasses.asdict(model)


def scan_from_numpy(ranges, bad, seg, device=None) -> Scan:
    """A port :class:`Scan` (copied) from array-likes ``[..., N]``."""
    return Scan(
        ranges=torch.tensor(np.asarray(ranges, np.float32), device=device),
        bad=torch.tensor(np.asarray(bad, bool), device=device),
        seg=torch.tensor(np.asarray(seg, np.int32), device=device),
    )


def scan_to_numpy(scan: Scan) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return tuple(x.detach().cpu().numpy() for x in scan)


def grid_from_numpy(log_odds, spec_fields: dict, device=None) -> OccupancyGrid:
    """A port grid from log-odds ``[H, W]`` and the field dict of a
    ``GridSpec2D``."""
    return OccupancyGrid(
        log_odds=torch.tensor(np.asarray(log_odds, np.float32), device=device),
        spec=GridSpec2D(**spec_fields),
    )


def grid_to_numpy(grid: OccupancyGrid) -> tuple[np.ndarray, dict]:
    return grid.log_odds.detach().cpu().numpy(), dataclasses.asdict(grid.spec)
