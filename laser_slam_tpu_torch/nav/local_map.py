"""Rolling egocentric local map (port of ``nav/local_map.py``).

One fixed-shape ``[H, W]`` log-odds block that scrolls with the robot.
Re-centering is a roll of the block plus a mask that blanks the revealed
strip, and scan integration is the two-scatter-add inverse sensor model
of the global mapper. The roll is an index gather by the shift the device
computes, so a scan's update reads nothing back to the host.

World points map to cells by ``floor(x / resolution)``, a true float32
division on every device (the reference's resolution is a traced value
of its map, not a constant its compiler could turn into a reciprocal
multiplication; ``tensor / float`` multiplies by the reciprocal on CUDA);
the bearings, the beams' sines and cosines and the
sample points ``pose + r·direction`` are rounded as the reference's
compiled update rounds them (:mod:`..core.refmath`), so that the card
and the CPU put every sample in the same cell. On CUDA the scatter-adds are atomic,
so the log-odds sums are order-dependent in the last bits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.scan import LaserModel, Scan
from ..core.refmath import bearings, fma, sincos
from ..mapping.occupancy import LO_FREE, LO_MAX, LO_MIN, LO_OCC

Tensor = torch.Tensor


class LocalMap(NamedTuple):
    """Egocentric rolling grid. ``origin_cell`` is the world-grid index
    (in cells, resolution-quantized) of array cell ``(0, 0)``: it moves
    with the robot, on the device."""

    log_odds: Tensor     # [H, W]
    origin_cell: Tensor  # [2] int32 (cx, cy) of cell (0, 0)
    resolution: float

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.log_odds.shape)

    def probability(self) -> Tensor:
        return 1.0 - 1.0 / (1.0 + torch.exp(self.log_odds))

    def occupied(self, threshold: float = 0.0) -> Tensor:
        return self.log_odds > threshold

    def origin_world(self) -> Tensor:
        return self.origin_cell.to(torch.float32) * self.resolution


def _div(x: Tensor, d: float) -> Tensor:
    """``x / d``, a true float32 division on every device: the divisor is
    a tensor on ``x``'s device."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def empty_local_map(
    size: int = 128, resolution: float = 0.1, pose=None, dtype=torch.float32, device=None
) -> LocalMap:
    """A ``size``² window (12.8 m at 10 cm by default) centered on
    ``pose`` (the origin if None), on ``device`` (``cuda`` unless the
    caller names another)."""
    dev = resolve_device(device)
    xy = torch.zeros(2, device=dev) if pose is None else \
        torch.as_tensor(pose, dtype=torch.float32, device=dev)[:2]
    origin = torch.floor(_div(xy, resolution)).to(torch.int32) - size // 2
    return LocalMap(
        log_odds=torch.zeros((size, size), dtype=dtype, device=dev),
        origin_cell=origin,
        resolution=float(resolution),
    )


def recenter(lmap: LocalMap, pose: Tensor) -> LocalMap:
    """Scroll the window so ``pose`` sits at the center cell; cells that
    scroll in are reset to unknown (log-odds 0)."""
    h, w = lmap.shape
    dev = lmap.log_odds.device
    half = torch.where(torch.arange(2, device=dev) == 0, w // 2, h // 2).to(torch.int32)
    want = torch.floor(_div(pose[:2], lmap.resolution)).to(torch.int32) - half
    shift = want - lmap.origin_cell  # [dx, dy] in cells
    iy = torch.arange(h, device=dev)
    ix = torch.arange(w, device=dev)
    # Rolling by -shift: cell i takes the content of cell i + shift.
    lo = lmap.log_odds[torch.remainder(iy + shift[1], h)[:, None],
                       torch.remainder(ix + shift[0], w)[None, :]]
    fresh_y = torch.where(shift[1] >= 0, iy >= h - shift[1], iy < -shift[1])
    fresh_x = torch.where(shift[0] >= 0, ix >= w - shift[0], ix < -shift[0])
    lo = torch.where(fresh_y[:, None] | fresh_x[None, :], 0.0, lo)
    return LocalMap(lo, want, lmap.resolution)


def update_local_map(
    lmap: LocalMap,
    model: LaserModel,
    scan: Scan,
    pose: Tensor,
    n_free_samples: int = 64,
) -> LocalMap:
    """Recenter on ``pose [3]`` and fuse one scan ``[N]`` (inverse sensor
    model: endpoint and free-space scatter-adds, then the clip to
    ``[LO_MIN, LO_MAX]``)."""
    lmap = recenter(lmap, pose)
    h, w = lmap.shape
    res = lmap.resolution

    r = scan.ranges
    valid = ~scan.bad & (r < model.max_range) & (r > model.min_range)
    dy, dx = sincos(pose[2] + bearings(model, r.device))
    # The free-space samples' loop (N × S elements) computes the bearings
    # again, each in its vectorized body.
    fdy, fdx = sincos(pose[2] + bearings(model, r.device, loop=r.numel() * n_free_samples))

    def to_cell(x, y):
        cx = torch.floor(_div(x, res)).to(torch.int32) - lmap.origin_cell[0]
        cy = torch.floor(_div(y, res)).to(torch.int32) - lmap.origin_cell[1]
        inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
        return torch.where(inb, cy * w + cx, 0), inb

    lo = lmap.log_odds.reshape(-1)

    flat, inb = to_cell(fma(r, dx, pose[0]), fma(r, dy, pose[1]))
    lo = lo.index_add(0, flat, torch.where(inb & valid, LO_OCC, 0.0))

    frac = (torch.arange(n_free_samples, dtype=r.dtype, device=r.device) + 0.5) / n_free_samples
    rs = torch.clamp(r[:, None] - res, min=0.0) * frac                 # [N, S]
    fflat, finb = to_cell(fma(rs, fdx[:, None], pose[0]), fma(rs, fdy[:, None], pose[1]))
    per = LO_FREE * _div(r[:, None], float(np.float32(n_free_samples) * np.float32(res)))
    lo = lo.index_add(0, fflat.reshape(-1),
                      torch.where(finb & valid[:, None], per, 0.0).reshape(-1))

    lo = torch.clamp(lo, LO_MIN, LO_MAX).reshape(h, w)
    return LocalMap(lo, lmap.origin_cell, lmap.resolution)


def obstacle_distance_field(lmap: LocalMap, threshold: float = 0.0) -> Tensor:
    """Per-cell exact Euclidean distance in meters to the nearest occupied
    cell (1e6 cells where there is none). Separable: the exact distance
    along each row by doubling min-plus passes (log₂ W), then
    ``D²(i, j) = min_k g²(k, j) + (i - k)²`` over the rows at once."""
    h, w = lmap.shape
    dev = lmap.log_odds.device
    big = 1e6

    # stage 1: exact per-row distance along x (in cells)
    d = torch.where(lmap.occupied(threshold), 0.0, big)
    ix = torch.arange(w, device=dev)[None, :]
    k = 1
    while k < w:
        plus = torch.where(ix >= k, torch.roll(d, k, dims=1) + k, big)
        minus = torch.where(ix < w - k, torch.roll(d, -k, dims=1) + k, big)
        d = torch.minimum(d, torch.minimum(plus, minus))
        k *= 2
    g2 = torch.clamp(d, max=big) ** 2  # squared row distance, [H, W]

    # stage 2: min over the source row k of g²(k, j) + (i - k)²
    iy = torch.arange(h, device=dev)
    dy2 = ((iy[:, None] - iy[None, :]) ** 2).to(torch.float32)          # [i, k]
    d2 = torch.amin(g2[None, :, :] + dy2[:, :, None], dim=1)
    return torch.sqrt(torch.clamp(d2, max=big)) * lmap.resolution


class LocalMapService:
    """Host-side owner of the rolling map (the ``LocalMapBuilder`` /
    ``AmbientGridMap`` role): ``stream_in`` a posed scan, read
    ``map`` / ``distance_field``. The map lives on ``device`` (``cuda``
    unless the caller names another)."""

    def __init__(self, model: LaserModel, size: int = 128, resolution: float = 0.1,
                 device=None):
        self.model = model
        self.device = resolve_device(device)
        self.map = empty_local_map(size, resolution, device=self.device)

    def stream_in(self, scan: Scan, pose) -> LocalMap:
        pose = torch.as_tensor(np.asarray(pose, np.float32)).to(self.device)
        self.map = update_local_map(self.map, self.model, scan, pose)
        return self.map

    def distance_field(self) -> Tensor:
        return obstacle_distance_field(self.map)
