"""Batched ray-cast scan simulation against an occupancy grid (port of
``localization/raycast.py``).

Instead of a per-beam walk over grid cells, every beam samples the grid
at a fixed ladder of ranges and finds the first occupied sample with one
``argmax``: a dense ``[P, N, S]`` gather with no data-dependent control
flow. Sample spacing equals the grid resolution, so accuracy matches a
DDA walk to within one cell.

Every function takes ``pose [..., 3]``: one pose, or a batch of poses
(a particle cloud) along leading axes. Cell indices are
``floor((x - origin) / resolution)`` with a true division, as the
functions of the original give when they are called outside a compiled
program.
"""

from __future__ import annotations

import torch

from ..core.scan import LaserModel
from ..mapping.occupancy import GridSpec2D, OccupancyGrid

Tensor = torch.Tensor

# Bytes one ``[N, S]`` sample of :func:`simulate_scan` holds at its peak:
# two float32 coordinates, two int64 cell indices, the flat index, the
# gathered probability and three masks.
SIMULATE_BYTES_PER_SAMPLE = 4 + 4 + 8 + 8 + 8 + 4 + 3


def _cells(spec: GridSpec2D, x: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
    """Flat cell index of world points and the in-bounds mask."""
    ix = torch.floor((x - spec.origin_x) / spec.resolution).to(torch.int64)
    iy = torch.floor((y - spec.origin_y) / spec.resolution).to(torch.int64)
    inb = (ix >= 0) & (ix < spec.width) & (iy >= 0) & (iy < spec.height)
    return iy * spec.width + ix, inb


def simulate_scan(
    grid: OccupancyGrid,
    model: LaserModel,
    pose: Tensor,
    max_range: float | None = None,
    occ_threshold: float = 0.5,
) -> Tensor:
    """Simulate ``[..., N]`` ranges from ``pose [..., 3]`` against the
    grid. It materialises ``[..., N, S]`` with ``S = max_range /
    resolution``: callers with many poses pass them in chunks
    (:func:`..particle_filter.update_beam` does)."""
    spec = grid.spec
    if max_range is None:
        max_range = model.max_range
    n_samples = int(max_range / spec.resolution)
    dtype, dev = pose.dtype, pose.device

    fi = model.bearings(dtype, dev)
    ang = pose[..., 2:3] + fi                                 # [..., N]
    rs = (torch.arange(n_samples, dtype=dtype, device=dev) + 1.0) * spec.resolution
    x = pose[..., 0:1, None] + rs * torch.cos(ang)[..., None]  # [..., N, S]
    y = pose[..., 1:2, None] + rs * torch.sin(ang)[..., None]

    flat, inb = _cells(spec, x, y)
    flat = torch.where(inb, flat, 0)
    occ = (torch.take(grid.probability, flat) > occ_threshold) & inb

    hit_any = torch.any(occ, dim=-1)
    first = torch.argmax(occ.to(torch.uint8), dim=-1)          # first occupied sample
    r_hit = (first.to(dtype) + 1.0) * spec.resolution
    return torch.where(hit_any, r_hit, max_range)


def beam_likelihood(
    grid: OccupancyGrid,
    model: LaserModel,
    pose: Tensor,
    ranges: Tensor,
    valid: Tensor,
    sigma: float = 0.5,
    max_range: float | None = None,
) -> Tensor:
    """Gaussian beam-likelihood ``[...]`` of an observed scan ``[N]``
    from ``pose [..., 3]``: ``mean_n exp(-(r_obs - r_sim)² / 2σ²)`` over
    valid beams."""
    sim = simulate_scan(grid, model, pose, max_range=max_range)
    dr = ranges - sim
    w = torch.exp(-0.5 * (dr / sigma) ** 2)
    n = torch.clamp(torch.sum(valid), min=1).to(w.dtype)
    return torch.sum(torch.where(valid, w, 0.0), dim=-1) / n


def likelihood_field(
    grid: OccupancyGrid, sigma: float = 0.2, n_iter: int | None = None
) -> Tensor:
    """Precomputed likelihood field: per-cell ``exp(-d²/2σ²)`` where d is
    the distance to the nearest occupied cell, by an iterated 3×3
    min-plus relaxation (a chamfer-style distance transform): ``n_iter``
    dense passes, no data-dependent control flow. The diagonal step
    costs √2 cells, so this is not a max-pool.

    This enables the fast endpoint observation model: transform scan
    endpoints by a particle pose and gather field values, thousands of
    particles in one batched gather (no ray marching at all).
    """
    spec = grid.spec
    res = spec.resolution
    if n_iter is None:
        n_iter = int(3.0 * sigma / res) + 1
    big = 1e3
    d = torch.where(grid.log_odds > 0.0, 0.0, big).to(grid.log_odds.dtype)
    c = res
    cd = res * 1.41421356
    for _ in range(n_iter):
        pads = torch.nn.functional.pad(d, (1, 1, 1, 1), value=big)
        axial = torch.minimum(
            torch.minimum(pads[:-2, 1:-1], pads[2:, 1:-1]),
            torch.minimum(pads[1:-1, :-2], pads[1:-1, 2:]),
        ) + c
        diagonal = torch.minimum(
            torch.minimum(pads[:-2, :-2], pads[:-2, 2:]),
            torch.minimum(pads[2:, :-2], pads[2:, 2:]),
        ) + cd
        d = torch.minimum(d, torch.minimum(axial, diagonal))
    return torch.exp(-0.5 * (d / sigma) ** 2)


def endpoint_likelihood(
    field: Tensor,
    spec: GridSpec2D,
    model: LaserModel,
    pose: Tensor,
    ranges: Tensor,
    valid: Tensor,
) -> Tensor:
    """Likelihood-field observation model ``[...]``: mean field value at
    the observed beam endpoints ``[N]`` transformed by ``pose [..., 3]``."""
    fi = model.bearings(pose.dtype, pose.device)
    ang = pose[..., 2:3] + fi
    x = pose[..., 0:1] + ranges * torch.cos(ang)
    y = pose[..., 1:2] + ranges * torch.sin(ang)
    flat, inb = _cells(spec, x, y)
    inb = valid & inb
    vals = torch.take(field, torch.where(inb, flat, 0))
    n = torch.clamp(torch.sum(inb, dim=-1), min=1).to(vals.dtype)
    return torch.sum(torch.where(inb, vals, 0.0), dim=-1) / n
