"""Occupancy-grid mapping with log-odds scatter updates (port of
``mapping/occupancy.py``).

Each beam adds ``LO_OCC`` at its endpoint cell and drops a fixed number
of free-space samples along its ray; the whole scan batch updates the
grid with two ``index_add_`` calls. On CUDA those are atomic adds, so
the log-odds sums are exact in the hit counts and order-dependent only
in the last bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.scan import LaserModel, Scan

Tensor = torch.Tensor

LO_OCC = 0.85     # log odds added at the beam endpoint
LO_FREE = -0.4    # log odds added along the free-space ray
LO_MIN, LO_MAX = -10.0, 10.0
SUBMAP_RESOLUTION = 0.05
LOCALIZATION_RESOLUTION = 0.02


@dataclasses.dataclass(frozen=True)
class GridSpec2D:
    """Static grid geometry: ``origin`` is the world position of cell
    (0, 0)'s corner; cells are square with side ``resolution``."""

    origin_x: float
    origin_y: float
    resolution: float
    width: int    # cells along x
    height: int   # cells along y

    def world_to_cell(self, xy: Tensor) -> Tensor:
        """``[..., 2]`` world points → integer cell indices ``(ix, iy)``.
        The division by the resolution is a multiplication by its float32
        reciprocal, as XLA compiles it."""
        inv = float(np.float32(1.0) / np.float32(self.resolution))
        gx = (xy[..., 0] - self.origin_x) * inv
        gy = (xy[..., 1] - self.origin_y) * inv
        return torch.stack(
            [torch.floor(gx).to(torch.int64), torch.floor(gy).to(torch.int64)],
            dim=-1,
        )

    def cell_centers_world(self, cells: Tensor) -> Tensor:
        return torch.stack(
            [
                (cells[..., 0] + 0.5) * self.resolution + self.origin_x,
                (cells[..., 1] + 0.5) * self.resolution + self.origin_y,
            ],
            dim=-1,
        )

    def contains(self, cells: Tensor) -> Tensor:
        return (
            (cells[..., 0] >= 0)
            & (cells[..., 0] < self.width)
            & (cells[..., 1] >= 0)
            & (cells[..., 1] < self.height)
        )


@dataclasses.dataclass
class OccupancyGrid:
    """Log-odds occupancy grid ``[H, W]`` (row = y, col = x)."""

    log_odds: Tensor
    spec: GridSpec2D

    @property
    def probability(self) -> Tensor:
        return torch.sigmoid(self.log_odds)

    @property
    def occupied(self) -> Tensor:
        return self.log_odds > 0.0

    @property
    def known(self) -> Tensor:
        return torch.abs(self.log_odds) > 1e-6


def empty_grid(spec: GridSpec2D, dtype=torch.float32, device=None) -> OccupancyGrid:
    return OccupancyGrid(
        log_odds=torch.zeros(spec.height, spec.width, dtype=dtype, device=device),
        spec=spec,
    )


def spec_for_trajectory(
    poses: np.ndarray,
    max_range: float,
    resolution: float = SUBMAP_RESOLUTION,
    margin: float = 1.0,
) -> GridSpec2D:
    """Grid covering a trajectory plus sensor range (host-side helper)."""
    xy = np.asarray(poses)[:, :2]
    lo = xy.min(axis=0) - max_range - margin
    hi = xy.max(axis=0) + max_range + margin
    w = int(np.ceil((hi[0] - lo[0]) / resolution))
    h = int(np.ceil((hi[1] - lo[1]) / resolution))
    return GridSpec2D(float(lo[0]), float(lo[1]), resolution, w, h)


def integrate_scans(
    grid: OccupancyGrid,
    model: LaserModel,
    scans: Scan,
    poses: Tensor,
    n_free_samples: int = 128,
) -> OccupancyGrid:
    """Fuse scans ``[T, N]`` posed at ``poses [T, 3]`` into the grid
    (endpoints + free-space samples); returns a new grid.

    Each free-space sample adds ``LO_FREE · r / (n_samples · res)`` so the
    expected decrement per traversed cell matches a Bresenham walk.
    """
    spec = grid.spec
    r = scans.ranges
    fi = model.bearings(r.dtype, r.device)                      # [N]
    valid = ~scans.bad & (r < model.max_range) & (r > model.min_range)

    ang = poses[:, 2:3] + fi[None, :]                           # [T, N]
    dx, dy = torch.cos(ang), torch.sin(ang)
    ex = poses[:, 0:1] + r * dx                                 # endpoints
    ey = poses[:, 1:2] + r * dy

    lo_flat = grid.log_odds.reshape(-1).clone()

    # --- occupied endpoints ---
    cells = spec.world_to_cell(torch.stack([ex, ey], dim=-1))   # [T, N, 2]
    inb = spec.contains(cells) & valid
    flat = torch.where(inb, cells[..., 1] * spec.width + cells[..., 0], 0)
    upd = torch.where(inb, LO_OCC, 0.0).to(r.dtype)
    lo_flat.index_add_(0, flat.reshape(-1), upd.reshape(-1))

    # --- free-space samples ---
    frac = (torch.arange(n_free_samples, dtype=r.dtype, device=r.device) + 0.5) / n_free_samples
    # Sample slightly short of the endpoint to avoid eroding the surface.
    rs = torch.clamp((r[..., None] - spec.resolution) * frac, min=0.0)  # [T, N, S]
    fx = poses[:, 0, None, None] + rs * dx[..., None]
    fy = poses[:, 1, None, None] + rs * dy[..., None]
    fcells = spec.world_to_cell(torch.stack([fx, fy], dim=-1))
    finb = spec.contains(fcells) & valid[..., None]
    fflat = torch.where(finb, fcells[..., 1] * spec.width + fcells[..., 0], 0)
    per_sample = LO_FREE * (r[..., None] / (n_free_samples * spec.resolution))
    fupd = torch.where(finb, per_sample, 0.0)
    lo_flat.index_add_(0, fflat.reshape(-1), fupd.reshape(-1))

    lo = torch.clamp(lo_flat, LO_MIN, LO_MAX).reshape(spec.height, spec.width)
    return OccupancyGrid(log_odds=lo, spec=spec)


def occupied_points(grid: OccupancyGrid, max_points: int) -> tuple[Tensor, Tensor]:
    """Up to ``max_points`` occupied cell centers as world points
    ``([P, 2], [P] valid-mask)``, highest log-odds first.

    Log-odds are clamped at ``LO_MAX``, so the cells of every
    well-observed wall tie; among equals the lower flat index comes
    first (a stable descending sort), which makes the cut at
    ``max_points`` deterministic."""
    flat = grid.log_odds.reshape(-1)
    score = torch.where(flat > 0.0, flat, -torch.inf)
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:max_points], idx[:max_points]
    valid = torch.isfinite(vals)
    iy = idx // grid.spec.width
    ix = idx % grid.spec.width
    pts = grid.spec.cell_centers_world(torch.stack([ix, iy], dim=-1)).to(flat.dtype)
    return pts, valid
