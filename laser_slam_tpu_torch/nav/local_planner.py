"""Egocentric local planner: seed-grow reachability + milestone dodge
(port of ``nav/local_planner.py``).

On a small robot-centric "instant view" grid built from the live scan:
flood-fill the free space reachable from the robot (an iterated masked
dilation), erode it by the robot footprint (one min-pool), pick a
*milestone* — the centroid of the farthest reachable free row — and the
farthest line target below it that the robot sees in a straight line;
line of sight is tested for every candidate row at once. The dodge path
is four waypoints in the robot frame.

Frame convention: the instant view is robot-centric, x forward (row), y
to the left (column), cell ``(ROBOT_ROW, W/2)`` is the robot.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core.scan import LaserModel, Scan
from ..core.refmath import bearings, fma, linspace01, sincos

Tensor = torch.Tensor

# Instant-view geometry: 20 × 50 cells at 0.1 m, a 2 m × 5 m forward window.
VIEW_W = 20
VIEW_H = 50
VIEW_RES = 0.1
ROBOT_ROW = 0          # robot sits at the bottom row, centre column


def instant_view(model: LaserModel, scan: Scan) -> Tensor:
    """Rasterize the live scan ``[N]`` into the egocentric grid
    ``[VIEW_H, VIEW_W]`` bool — True = obstacle: each beam landing inside
    the window marks its endpoint cell. Cells follow ``floor(x ·
    (1/VIEW_RES))`` in float32, as the reference compiles them, from
    bearings, sines and cosines rounded as the reference's
    (:mod:`..core.refmath`)."""
    r = scan.ranges
    ok = ~scan.bad & (r > model.min_range) & (r < model.max_range)
    sin, cos = sincos(bearings(model, r.device))
    inv = float(np.float32(1.0) / np.float32(VIEW_RES))
    row = torch.floor(r * cos * inv).to(torch.int32)                    # forward
    col = torch.floor(r * sin * inv).to(torch.int32) + VIEW_W // 2      # left
    inside = ok & (row >= 0) & (row < VIEW_H) & (col >= 0) & (col < VIEW_W)
    flat = torch.where(inside, row * VIEW_W + col, VIEW_H * VIEW_W)
    grid = torch.zeros(VIEW_H * VIEW_W + 1, dtype=torch.bool, device=r.device)
    grid = grid.index_fill(0, flat.to(torch.int64), True)
    return grid[:-1].reshape(VIEW_H, VIEW_W)


def seed_grow(obstacle: Tensor, seed_rc: tuple[int, int] | None = None) -> Tensor:
    """Free space *reachable* from the seed cell: ``h + w`` passes of a
    4-neighbour dilation masked by the free cells."""
    h, w = obstacle.shape
    if seed_rc is None:
        seed_rc = (ROBOT_ROW, w // 2)
    free = (~obstacle).to(torch.float32)[None, None]
    reach = torch.zeros_like(free)
    reach[0, 0, seed_rc[0], seed_rc[1]] = free[0, 0, seed_rc[0], seed_rc[1]]
    for _ in range(h + w):
        grown = torch.maximum(F.max_pool2d(reach, (3, 1), stride=1, padding=(1, 0)),
                              F.max_pool2d(reach, (1, 3), stride=1, padding=(0, 1)))
        reach = grown * free
    return reach[0, 0] > 0.0


def erode_by_robot(reach: Tensor, robot_cells: int = 2) -> Tensor:
    """Shrink the reachable region by the robot half-width: a cell stays
    traversable only if its ``(2r+1)²`` neighbourhood is fully reachable.
    The window's edge is not an obstacle (edge padding): only observed
    obstacle cells erode. The ``r`` iterated 3×3 erosions are one max-pool
    of the complement."""
    if robot_cells <= 0:
        return reach
    r = robot_cells
    hole = (~reach).to(torch.float32)[None, None]
    hole = F.pad(hole, (r, r, r, r), mode="replicate")
    return F.max_pool2d(hole, 2 * r + 1, stride=1)[0, 0] == 0.0


class Milestone(NamedTuple):
    ok: Tensor            # [] bool — a dodge path exists
    target_rc: Tensor     # [2] float cell coords of the line target
    milestone_rc: Tensor  # [2] float cell coords of the milestone
    path_xy: Tensor       # [4, 2] waypoints in robot frame [m]


def milestone_select(traversable: Tensor) -> Milestone:
    """Milestone + obstacle-free approach line for a traversable grid
    ``[H, W]`` bool: the farthest row with free space, the centroid of its
    free cells, and the farthest row at or below it whose straight line
    from the robot (sampled at ``2H`` points, rounded to cells) lies on
    traversable cells only."""
    h, w = traversable.shape
    dev = traversable.device
    dtype = torch.float32
    rows = torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)

    has_free = traversable.sum(dim=1) > 0
    far_row = torch.max(torch.where(has_free, rows, -1))
    ok = far_row > 0
    row_mask = traversable[torch.clamp(far_row, 0, h - 1)]
    n_free = row_mask.sum()
    mid_col = torch.where(
        n_free > 0,
        torch.sum(torch.where(row_mask, cols, 0)) / torch.clamp(n_free, min=1),
        w / 2.0,
    ).to(dtype)

    n_s = 2 * h
    t = linspace01(n_s, dev)[None, :]                            # [1, S]
    r0, c0 = float(ROBOT_ROW), float(w // 2)
    rr = r0 + (rows.to(dtype)[:, None] - r0) * t                          # [H, S]
    cc = fma(mid_col - c0, t, c0)                                         # [1, S]
    ri = torch.clamp(torch.round(rr).to(torch.int64), 0, h - 1)
    ci = torch.clamp(torch.round(cc).to(torch.int64), 0, w - 1).expand_as(ri)
    line_free = torch.all(traversable[ri, ci], dim=1)                     # [H]
    # Only rows at-or-below the milestone row qualify as line targets.
    cand = line_free & (rows <= far_row) & (rows > 0)
    end_row = torch.max(torch.where(cand, rows, 0)).to(dtype)
    ok = ok & torch.any(cand)

    def rc_to_xy(r, c):
        return torch.stack([(r - r0) * VIEW_RES, (c - c0) * VIEW_RES]).to(dtype)

    # Robot → short nudge on the verified line → line target → milestone.
    p0 = torch.zeros(2, dtype=dtype, device=dev)
    nudge_row = torch.clamp(end_row, max=5.0)
    t_n = (nudge_row - r0) / torch.clamp(end_row - r0, min=1e-6)
    # ``rc_to_xy(nudge_row, c0 + (mid_col - c0)·t_n)``, with the ``c0``
    # round trip cancelled as the reference's compiled form cancels it.
    p1 = torch.stack([(nudge_row - r0) * VIEW_RES, ((mid_col - c0) * t_n) * VIEW_RES])
    p2 = rc_to_xy(end_row, mid_col)
    p3 = rc_to_xy(far_row.to(dtype), mid_col)
    return Milestone(
        ok=ok,
        target_rc=torch.stack([end_row, mid_col]),
        milestone_rc=torch.stack([far_row.to(dtype), mid_col]),
        path_xy=torch.stack([p0, p1, p2, p3]),
    )


def dodge_path(model: LaserModel, scan: Scan, robot_cells: int = 2) -> Milestone:
    """Full local dodge: instant view → seed-grow → erode → milestone.
    ``path_xy`` is in the ROBOT frame; compose with the robot pose for
    world-frame waypoints."""
    view = instant_view(model, scan)
    reach = seed_grow(view)
    trav = erode_by_robot(reach, robot_cells)
    # The robot's own cell survives erosion even when an obstacle is
    # adjacent, so that lines can start.
    c = view.shape[1] // 2
    trav = trav.clone()
    trav[ROBOT_ROW, c] = reach[ROBOT_ROW, c]
    return milestone_select(trav)
