"""Batched ray-cast scan simulation against an occupancy grid (port of
``localization/raycast.py``).

:func:`simulate_scan` gives each (pose, beam) ray the range of its first
occupied sample on a fixed ladder of ranges, one sample a grid
resolution, so accuracy matches a DDA walk to within one cell. On CUDA
tensors a hand-written kernel (``ops/cuda/raycast_kernel``) walks each
ray from its first sample and stops at its first occupied cell. On CPU
tensors the plain version, :func:`_simulate_scan_ladder`, samples the
grid at the whole ladder, a dense ``[P, N, S]`` gather with no
data-dependent control flow, and finds the first occupied sample with
one ``argmax``. The two give the same ranges bit for bit on one device.

Every function takes ``pose [..., 3]``: one pose, or a batch of poses
(a particle cloud) along leading axes. Cell indices are
``floor((x - origin) / resolution)`` with a true division, as the
functions of the original give when they are called outside a compiled
program (on the card PyTorch multiplies by the reciprocal, and the
kernel does the same).
"""

from __future__ import annotations

import torch

from ..core.scan import LaserModel
from ..mapping.occupancy import GridSpec2D, OccupancyGrid
from ..ops.cuda.raycast_kernel import ray_march
from ..utils.profiling import profiler

Tensor = torch.Tensor

# Bytes one ``[N, S]`` sample of the CPU ladder holds at its peak: two
# float32 coordinates, two int64 cell indices, the flat index, the
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
    grid: each beam's range is ``(k + 1) · resolution`` of its first
    sample ``k < S = max_range / resolution`` on a cell whose probability
    is above ``occ_threshold``, ``max_range`` where there is none.

    On CUDA tensors the kernel walks each ray to its first hit
    (``ray_march``: one launch a call, counted in the profiler's
    ``raycast.march_launches``); it takes float32 and raises on anything
    else. On CPU tensors the dense ladder materialises ``[..., N, S]``
    (:func:`_simulate_scan_ladder`), so callers with many poses pass them
    in chunks (:func:`..particle_filter.update_beam` does)."""
    if not pose.is_cuda:
        return _simulate_scan_ladder(grid, model, pose, max_range, occ_threshold)
    spec = grid.spec
    if max_range is None:
        max_range = model.max_range
    n = model.n_beams
    ang = pose[..., 2:3] + model.bearings(pose.dtype, pose.device)    # [..., N]
    occupied = grid.probability > occ_threshold
    out = ray_march(occupied, pose.reshape(-1, 3).contiguous(), torch.cos(ang).reshape(-1, n),
                    torch.sin(ang).reshape(-1, n), spec.origin_x, spec.origin_y, spec.resolution,
                    int(max_range / spec.resolution), max_range)
    profiler.count("raycast.march_launches", 1)
    return out.reshape(ang.shape)


def _simulate_scan_ladder(
    grid: OccupancyGrid,
    model: LaserModel,
    pose: Tensor,
    max_range: float | None = None,
    occ_threshold: float = 0.5,
) -> Tensor:
    """The plain version of :func:`simulate_scan`, on any device: every
    beam samples the grid at the whole ladder ``[..., N, S]`` and the
    first occupied sample is found with one ``argmax``."""
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
    rows: int | None = None,
) -> Tensor:
    """Gaussian beam-likelihood ``[...]`` of an observed scan ``[N]``
    from ``pose [..., 3]``: ``mean_n exp(-(r_obs - r_sim)² / 2σ²)`` over
    valid beams. With ``rows`` (poses ``[P, 3]``) each pose's beams are
    summed as calls of ``rows`` poses at a time sum them
    (:func:`_sum_in_chunks`), which gives the same likelihoods bit for
    bit."""
    sim = simulate_scan(grid, model, pose, max_range=max_range)
    dr = ranges - sim
    w = torch.exp(-0.5 * (dr / sigma) ** 2)
    n = torch.clamp(torch.sum(valid), min=1).to(w.dtype)
    kept = torch.where(valid, w, 0.0)
    return (torch.sum(kept, dim=-1) if rows is None else _sum_in_chunks(kept, rows)) / n


def _sum_in_chunks(x: Tensor, rows: int) -> Tensor:
    """Row sums of ``x [P, N]``, each rounded as PyTorch rounds it in a
    tensor of its own chunk of ``rows`` rows (the last chunk holding the
    rest). On the card a float32 row sum depends on where the row starts
    (the vectorised loads begin at its 16-byte alignment) and on the
    height of the thread block, which follows the rows of the call; so
    one call over a cloud differs in the last bit from calls over its
    chunks. The whole chunks are copied into a stack in which each one
    starts on 16 bytes and summed in one call: once a chunk holds 16 rows,
    the block's full height, each row is then summed as in its chunk
    alone. Smaller chunks are summed one by one.

    A stop-gap, not a design: it exists only so that the weights equal,
    in the last bit, those of a reference that sums the ladder's chunks
    (the benchmark's comparison turns a 1-ulp weight difference into cm
    of estimate through resampling), and it leans on how this build of
    PyTorch lays out its reduction. Once that comparison tolerates
    last-bit weight rounding, ``rows`` and this function go and one
    ``torch.sum`` stays."""
    p, n = x.shape
    if rows >= p:
        return torch.sum(x, dim=-1)
    if rows < 16:
        return torch.cat([torch.sum(x[i:i + rows].clone(), dim=-1) for i in range(0, p, rows)])
    full, per = p // rows, rows * n
    stack = x.new_empty(full, -(-per // 4) * 4)[:, :per]
    stack.copy_(x[:full * rows].view(full, per))
    sums = [torch.sum(stack.view(full, rows, n), dim=-1).reshape(-1)]
    if full * rows < p:
        sums.append(torch.sum(x[full * rows:].clone(), dim=-1))
    return torch.cat(sums)


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
