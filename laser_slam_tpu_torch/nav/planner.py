"""Grid path planning as iterated stencil relaxation (port of
``nav/planner.py``).

The wavefront — a chamfer distance-to-goal propagated around obstacles —
is an iterated 3×3 min-plus stencil over the whole grid; the path follows
it downhill for a fixed number of 8-neighbour steps. Both loops run on the
grid's device with no host sync inside: the caller reads ``reached`` and
``n_valid`` after the plan.

Device operations a plan issues: one max-pool for the inflation, 12 a
wavefront pass (``width + height`` passes by default) and about 30 a
descent step (``max_steps`` steps).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.refmath import fma
from ..mapping.occupancy import OccupancyGrid

Tensor = torch.Tensor

BIG = 1e6
# The eight descent moves, in the order whose first minimum wins a tie.
OFFSETS = ((-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1))


def inflate_obstacles(grid: OccupancyGrid, robot_radius: float) -> Tensor:
    """Boolean obstacle mask ``[H, W]`` inflated by the robot radius: the
    occupied cells dilated ``max(int(robot_radius / resolution), 1)``
    times by a 3×3 square. The iterated dilation is one max-pool of side
    ``2n + 1`` (padding counts as free)."""
    n = max(int(robot_radius / grid.spec.resolution), 1)
    occ = (grid.log_odds > 0.0).to(torch.float32)
    return F.max_pool2d(occ[None, None], 2 * n + 1, stride=1, padding=n)[0, 0] > 0.0


def wavefront(obstacles: Tensor, goal_cell: Tensor, resolution: float, n_iter: int) -> Tensor:
    """Distance-to-goal field ``[H, W]`` propagated around obstacles.

    ``n_iter`` bounds the wavefront radius in cells (one stencil pass
    extends the front by one cell). Each pass takes the straight
    neighbours' minimum plus ``resolution`` and the diagonal ones' plus
    ``resolution·√2``, in the float32 order of the reference."""
    h, w = obstacles.shape
    d = torch.full((h, w), BIG, dtype=torch.float32, device=obstacles.device)
    d[goal_cell[1], goal_cell[0]] = 0.0
    blocked = torch.where(obstacles, BIG, 0.0)
    c, cd = resolution, resolution * 1.41421356
    for _ in range(n_iter):
        p = F.pad(d, (1, 1, 1, 1), value=BIG)
        straight = torch.minimum(torch.minimum(p[:-2, 1:-1], p[2:, 1:-1]),
                                 torch.minimum(p[1:-1, :-2], p[1:-1, 2:])) + c
        diagonal = torch.minimum(torch.minimum(p[:-2, :-2], p[:-2, 2:]),
                                 torch.minimum(p[2:, :-2], p[2:, 2:])) + cd
        d = torch.minimum(d, torch.minimum(straight, diagonal) + blocked)
    return d


class PlanResult(NamedTuple):
    path: Tensor     # [K, 2] world waypoints (padded with the last point)
    length: Tensor   # [] path length [m]
    reached: Tensor  # [] bool — goal connected to start
    n_valid: Tensor  # [] int32 — number of real waypoints


def _at(field: Tensor, y: Tensor, x: Tensor) -> Tensor:
    """``field[y, x]`` with the reference's gather semantics: a negative
    index counts from the end, then indices clamp into the array."""
    h, w = field.shape
    y = torch.clamp(torch.where(y < 0, y + h, y), 0, h - 1)
    x = torch.clamp(torch.where(x < 0, x + w, x), 0, w - 1)
    return field[y, x]


def plan_path(
    grid: OccupancyGrid,
    start_xy: Tensor,
    goal_xy: Tensor,
    robot_radius: float = 0.3,
    max_steps: int = 1024,
    max_wave_iters: int | None = None,
) -> PlanResult:
    """Plan a collision-free path start→goal on the occupancy grid: the
    wavefront from the goal, then ``max_steps`` downhill 8-neighbour steps
    from the start, on the grid's device.

    World points map to cells by truncation of ``(xy - origin) ·
    (1/resolution)``, the float32 reciprocal multiplication the reference
    compiles its division by the resolution into."""
    spec = grid.spec
    res = spec.resolution
    dev = grid.log_odds.device
    if max_wave_iters is None:
        max_wave_iters = spec.width + spec.height

    obstacles = inflate_obstacles(grid, robot_radius)
    inv = float(np.float32(1.0) / np.float32(res))

    def to_cell(xy):
        xy = torch.as_tensor(xy, dtype=torch.float32, device=dev)
        return torch.stack([
            torch.clamp(((xy[0] - spec.origin_x) * inv).to(torch.int32), 0, spec.width - 1),
            torch.clamp(((xy[1] - spec.origin_y) * inv).to(torch.int32), 0, spec.height - 1),
        ])

    goal_c = to_cell(goal_xy)
    start_c = to_cell(start_xy)
    dist = wavefront(obstacles, goal_c, res, max_wave_iters)

    offs = torch.tensor(OFFSETS, dtype=torch.int32, device=dev)
    cells = torch.empty((max_steps, 2), dtype=torch.int32, device=dev)
    cell, done = start_c, torch.zeros((), dtype=torch.bool, device=dev)
    for i in range(max_steps):
        nbrs = cell[None, :] + offs                                  # [8, 2]
        vals = dist[torch.clamp(nbrs[:, 1], 0, spec.height - 1),
                    torch.clamp(nbrs[:, 0], 0, spec.width - 1)]
        k = torch.argmin(vals)
        better = vals[k] < _at(dist, cell[1], cell[0])
        cell = torch.where(better & ~done, nbrs[k], cell)
        done = done | torch.all(cell == goal_c) | ~better
        cells[i] = cell

    path = torch.stack([fma(cells[:, 0] + 0.5, res, spec.origin_x),
                        fma(cells[:, 1] + 0.5, res, spec.origin_y)], dim=-1)
    reached_mask = torch.all(cells == goal_c[None, :], dim=1)
    reached = torch.any(reached_mask)
    n_valid = torch.where(reached, torch.argmax(reached_mask.to(torch.uint8)) + 1,
                          max_steps).to(torch.int32)
    seg = torch.linalg.vector_norm(torch.diff(path, dim=0), dim=-1)
    live = torch.arange(max_steps - 1, device=dev) < (n_valid - 1)
    length = torch.sum(torch.where(live, seg, 0.0))
    start_dist = dist[start_c[1], start_c[0]]
    return PlanResult(path=path, length=length, reached=reached & (start_dist < BIG),
                      n_valid=n_valid)
