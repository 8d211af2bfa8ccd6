"""Correlative scan matching: exhaustive pose-grid search, batched over
pairs (port of ``ops/correlative.py``).

The reference scan is rasterized into a blurred likelihood grid; every
pose of a (θ, tx, ty) volume is scored by the mean grid value under the
transformed current scan. For all translations at once this is the
cross-correlation of the grid with the rotated cloud's raster: one
grouped ``conv2d`` over the pairs of a batch. The gather path
(:func:`_score_theta`, ``match_correlative(conv=False)``) looks every
shifted point up instead, one rotation at a time. A trimmed point-ICP
polish recovers sub-cell accuracy.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import se2
from ..core.scan import LaserModel, Scan
from ..utils.profiling import trace
from .icp_points import match_icp_points, scan_to_points

Tensor = torch.Tensor

GRID_RES = 0.10          # [m] cell size of the likelihood grid
GRID_HALF_EXTENT = 12.8  # [m] half-width of the grid (256 cells at 10 cm)
BLUR_SIGMA_CELLS = 1.0   # Gaussian blur of the hit grid, in cells
MIN_SCORE = 0.25         # acceptance floor on mean point likelihood


class CorrelativeResult(NamedTuple):
    pose: Tensor    # [B, 3] best relative pose (cur in ref frame)
    score: Tensor   # [B] mean per-point likelihood of the best pose (0..1)
    fail: Tensor    # [B] bool


def _conv2d(x: Tensor, w: Tensor, groups: int) -> Tensor:
    """float32 cross-correlation with TF32 off: cuDNN would otherwise
    round the inputs to 10-bit mantissas and reorder near-tied peaks."""
    if x.is_cuda:
        with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False,
        ):
            return F.conv2d(x, w, groups=groups)
    return F.conv2d(x, w, groups=groups)


def _cell(v: Tensor, half_extent: float, res: float) -> Tensor:
    """Grid cell index ``floor((v + half_extent) / res)``. The division by
    the constant is a multiplication by its float32 reciprocal, as XLA
    compiles it."""
    inv = float(np.float32(1.0) / np.float32(res))
    return torch.floor((v + half_extent) * inv).to(torch.int64)


def _linspace(start: float, stop: float, num: int, dtype, device) -> Tensor:
    """``start·(1-s) + stop·s`` over ``s = i/(num-1)``, endpoint exact
    (the float32 formulation of ``jnp.linspace``)."""
    div = num - 1
    s = torch.arange(div, dtype=dtype, device=device) / div
    out = start * (1 - s) + stop * s
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])


def build_likelihood_grid_points(
    pts: Tensor,
    ok: Tensor,
    res: float = GRID_RES,
    half_extent: float = GRID_HALF_EXTENT,
    blur_sigma: float = BLUR_SIGMA_CELLS,
) -> Tensor:
    """Rasterize masked points ``[B, N, 2]`` into blurred likelihood
    grids ``[B, G, G]`` (origin at the center, row = y), values in [0, 1]."""
    b = pts.shape[0]
    g = int(round(2 * half_extent / res))
    dtype, dev = pts.dtype, pts.device
    ix = _cell(pts[..., 0], half_extent, res)
    iy = _cell(pts[..., 1], half_extent, res)
    inb = ok & (ix >= 0) & (ix < g) & (iy >= 0) & (iy < g)
    base = torch.arange(b, device=dev)[:, None] * (g * g)
    flat = torch.where(inb, base + iy * g + ix, 0)
    hits = torch.zeros(b * g * g, dtype=dtype, device=dev).index_add_(
        0, flat.reshape(-1), inb.to(dtype).reshape(-1)
    )
    grid = torch.clamp(hits.reshape(b, 1, g, g), 0.0, 1.0)

    # Separable Gaussian blur (5-cell kernel, peak 1), zero padded.
    r = torch.arange(-2, 3, dtype=dtype, device=dev)
    k = torch.exp(-0.5 * (r / blur_sigma) ** 2)
    grid = _conv2d(F.pad(grid, (2, 2, 0, 0)), k.view(1, 1, 1, 5), 1)
    grid = _conv2d(F.pad(grid, (0, 0, 2, 2)), k.view(1, 1, 5, 1), 1)
    return torch.clamp(grid[:, 0], 0.0, 1.0)


def build_likelihood_grid(
    model: LaserModel,
    scan: Scan,
    res: float = GRID_RES,
    half_extent: float = GRID_HALF_EXTENT,
    blur_sigma: float = BLUR_SIGMA_CELLS,
) -> Tensor:
    """Likelihood grids ``[B, G, G]`` of scans' endpoints (sensor at the
    center)."""
    pts, ok = scan_to_points(model, scan)
    return build_likelihood_grid_points(pts, ok, res, half_extent, blur_sigma)


def correlative_score_volume(
    grid: Tensor,
    pts: Tensor,
    ok: Tensor,
    thetas: Tensor,
    n_steps: int,
    res: float,
    half_extent: float,
    base_xy: Tensor,
    overlap_norm: bool = False,
    overlap_floor: float = 0.35,
    overlap_radius: float = 1.5,
) -> Tensor:
    """Score volumes ``[B, K, T, T]`` (θ, y-shift, x-shift) of mean point
    likelihood for grids ``[B, G, G]``, clouds ``[B, N, 2]`` / ``[B, N]``,
    rotations ``[B, K]`` and base offsets ``[B, 2]``.

    Each cloud, rotated by each θ and offset by ``base_xy``, is rasterized
    into a ``[G, G]`` count kernel; a point whose rotated base cell falls
    outside the raster is dropped for every shift. The volume is the
    ``VALID`` cross-correlation of the zero-padded grid with those
    kernels, one convolution group per pair.

    ``overlap_norm`` divides by the number of query points landing in
    ref-covered territory (occupied raster dilated by ``overlap_radius``)
    instead of by all valid points, floored at ``overlap_floor`` of the
    valid count.
    """
    b, g = grid.shape[0], grid.shape[-1]
    dtype, dev = grid.dtype, grid.device
    k = thetas.shape[-1]
    t = 2 * n_steps + 1

    c, s = torch.cos(thetas)[..., None], torch.sin(thetas)[..., None]   # [B, K, 1]
    px, py = pts[:, None, :, 0], pts[:, None, :, 1]                    # [B, 1, N]
    rx = px * c - py * s + base_xy[:, 0, None, None]
    ry = px * s + py * c + base_xy[:, 1, None, None]
    ix = _cell(rx, half_extent, res)                                   # [B, K, N]
    iy = _cell(ry, half_extent, res)
    inb = ok[:, None, :] & (ix >= 0) & (ix < g) & (iy >= 0) & (iy < g)
    plane = torch.arange(b * k, device=dev).view(b, k, 1) * (g * g)
    flat = torch.where(inb, plane + iy * g + ix, 0)
    raster = torch.zeros(b * k * g * g, dtype=dtype, device=dev).index_add_(
        0, flat.reshape(-1), inb.to(dtype).reshape(-1)
    ).view(b * k, 1, g, g)

    n_valid = torch.clamp(torch.sum(ok, dim=-1), min=1).to(dtype)      # [B]
    if not overlap_norm:
        pad = F.pad(grid, (n_steps,) * 4)[None]                        # [1, B, ., .]
        with trace("h2_score_volume_conv"):
            vol = _conv2d(pad, raster, b).view(b, k, t, t)
        return vol / n_valid[:, None, None, None]

    w = 2 * max(int(round(overlap_radius / res)), 1) + 1
    cover = F.max_pool2d(
        (grid > 0.05).to(dtype)[:, None], w, stride=1, padding=w // 2
    )[:, 0]
    both = torch.stack([grid, cover])                                  # [2, B, G, G]
    pad = F.pad(both, (n_steps,) * 4)
    with trace("h2_score_volume_conv"):
        out = _conv2d(pad, raster, b).view(2, b, k, t, t)
    vol, n_overlap = out[0], out[1]
    denom = torch.maximum(n_overlap, overlap_floor * n_valid[:, None, None, None])
    return vol / denom


def _score_theta(
    grid: Tensor,
    res: float,
    half_extent: float,
    pts: Tensor,      # [B, N, 2]
    valid: Tensor,    # [B, N]
    theta: Tensor,    # [B]
    steps: Tensor,    # [T] translation offsets (multiples of res)
    base_xy: Tensor,  # [B, 2]
) -> Tensor:
    """Score grids ``[B, Tx, Ty]`` for one rotation per pair: the mean
    point likelihood at every (tx, ty) shift, each shifted point looked up
    in the grid. The shift moves whole cells, so one floor and integer
    offsets cover the window. A point counts wherever its shifted cell
    lies on the grid (the convolution path drops a point whose unshifted
    cell lies off it, for every shift)."""
    b, g = grid.shape[0], grid.shape[-1]
    c, s = torch.cos(theta)[:, None], torch.sin(theta)[:, None]
    rx = pts[..., 0] * c - pts[..., 1] * s + base_xy[:, 0:1]
    ry = pts[..., 0] * s + pts[..., 1] * c + base_xy[:, 1:2]
    ix = _cell(rx, half_extent, res)                             # [B, N]
    iy = _cell(ry, half_extent, res)
    inv = float(np.float32(1.0) / np.float32(res))
    off = torch.round(steps * inv).to(torch.int64)               # [T]

    gx = ix[..., None] + off                                     # [B, N, Tx]
    gy = iy[..., None] + off                                     # [B, N, Ty]
    okx = (gx >= 0) & (gx < g)
    oky = (gy >= 0) & (gy < g)
    flat = gy.clamp(0, g - 1)[:, :, None, :] * g + gx.clamp(0, g - 1)[:, :, :, None]
    vals = torch.gather(grid.reshape(b, 1, -1).expand(b, flat.shape[1], g * g), 2,
                        flat.reshape(b, flat.shape[1], -1)).view(flat.shape)
    ok = valid[:, :, None, None] & okx[..., :, None] & oky[..., None, :]
    vals = torch.where(ok, vals, 0.0)
    n = torch.clamp(torch.sum(valid, dim=-1), min=1).to(vals.dtype)
    return torch.sum(vals, dim=1) / n[:, None, None]             # [B, Tx, Ty]


def match_correlative(
    model: LaserModel,
    ref: Scan,
    cur: Scan,
    init_pose: Tensor | None = None,
    search_xy: float = 2.4,
    search_theta: float = math.pi,
    n_theta: int = 72,
    res: float = GRID_RES,
    refine: bool = True,
    prior_xy: float = 0.02,
    prior_theta: float = 0.005,
    conv: bool = True,
) -> CorrelativeResult:
    """Correlative match of ``cur`` against ``ref`` (``[B, N]`` scans)
    over ``±search_xy [m] × ±search_theta [rad]`` centered on
    ``init_pose [B, 3]``, then a trimmed point-ICP polish.

    ``prior_xy``/``prior_theta`` add a quadratic penalty on distance from
    ``init_pose`` that breaks the ties of flat score plateaus. ``conv``
    picks the score volume: the convolution, or (``False``) the gather
    path of :func:`_score_theta`, a rotation at a time; the two differ
    only for points near the grid's edge.
    """
    dtype, dev = cur.ranges.dtype, cur.ranges.device
    b = cur.ranges.shape[0]
    if init_pose is None:
        init_pose = torch.zeros(b, 3, dtype=dtype, device=dev)

    grid = build_likelihood_grid(model, ref, res=res)
    pts, valid = scan_to_points(model, cur)

    thetas = init_pose[:, 2:3] + _linspace(
        -search_theta, search_theta, n_theta, dtype, dev
    )                                                                  # [B, K]
    n_steps = int(search_xy / res)
    steps = torch.arange(-n_steps, n_steps + 1, dtype=dtype, device=dev) * res

    if conv:
        score = correlative_score_volume(
            grid, pts, valid, thetas, n_steps, res, GRID_HALF_EXTENT, init_pose[:, :2]
        ).transpose(2, 3)                                              # [B, K, Tx, Ty]
    else:
        score = torch.stack([
            _score_theta(grid, res, GRID_HALF_EXTENT, pts, valid, thetas[:, k], steps,
                         init_pose[:, :2])
            for k in range(thetas.shape[1])
        ], dim=1)                                                      # [B, K, Tx, Ty]
    dth_pen = se2.normalize_angle(thetas - init_pose[:, 2:3]) ** 2
    sq = steps ** 2
    penalty = (
        prior_theta * dth_pen[:, :, None, None]
        + prior_xy * sq[None, None, :, None]
        + prior_xy * sq[None, None, None, :]
    )
    score = (score - penalty).reshape(b, -1)
    kbest = torch.argmax(score, dim=-1)                            # first on ties
    best = torch.gather(score, 1, kbest[:, None])[:, 0]
    t = steps.shape[0]
    kk, ka, kb = kbest // (t * t), (kbest // t) % t, kbest % t
    pose = torch.stack(
        [
            init_pose[:, 0] + steps[ka],
            init_pose[:, 1] + steps[kb],
            se2.normalize_angle(torch.gather(thetas, 1, kk[:, None])[:, 0]),
        ],
        dim=-1,
    )

    if refine:
        ref_pts, ref_ok = scan_to_points(model, ref)
        icp = match_icp_points(
            ref_pts, ref_ok, pts, valid, pose, iters=15, max_corr=3.0 * res
        )
        pose = torch.where(icp.fail[:, None], pose, icp.pose)

    return CorrelativeResult(pose=pose, score=best, fail=best < MIN_SCORE)


def _search_grid(init_pose: Tensor, search_xy: float, search_theta: float,
                 n_theta: int, res: float):
    """Rotations ``[B, K]`` about ``init_pose``'s heading, the half-width
    of the translation window in cells, and its offsets ``[T]``."""
    dtype, dev = init_pose.dtype, init_pose.device
    thetas = init_pose[:, 2:3] + _linspace(-search_theta, search_theta, n_theta, dtype, dev)
    n_steps = int(round(search_xy / res))
    steps = torch.arange(-n_steps, n_steps + 1, dtype=dtype, device=dev) * res
    return thetas, n_steps, steps


def _poses_at(init_pose: Tensor, thetas: Tensor, steps: Tensor, idx: Tensor) -> Tensor:
    """Poses ``[B, P, 3]`` of the flat volume cells ``idx [B, P]`` (θ,
    y-shift, x-shift order)."""
    t = steps.shape[0]
    kk, ka, kb = idx // (t * t), (idx // t) % t, idx % t
    return torch.stack(
        [
            init_pose[:, 0:1] + steps[kb],                 # x from the last axis
            init_pose[:, 1:2] + steps[ka],                 # y from the middle axis
            se2.normalize_angle(torch.gather(thetas, 1, kk)),
        ],
        dim=-1,
    )


def correlative_top_peaks(
    ref_pts: Tensor,
    ref_ok: Tensor,
    cur_pts: Tensor,
    cur_ok: Tensor,
    init_pose: Tensor,
    n_peaks: int = 4,
    search_xy: float = 5.0,
    search_theta: float = math.pi,
    n_theta: int = 72,
    res: float = 0.3,
    half_extent: float = 12.8,
    blur_sigma: float = 1.0,
    overlap_norm: bool = False,
    grid: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Top ``n_peaks`` non-max-suppressed local maxima of the correlative
    score volumes of a batch of cloud pairs: ``(poses [B, P, 3], scores
    [B, P])``, best first. Pass prebuilt ``grid [B, G, G]`` to amortize
    the rasterization over several query clouds against one reference.

    Partial-overlap matching (loop closure between submaps that share
    only part of their coverage) routinely puts the *true* alignment at
    a secondary peak, so every peak must be polished and gated, not just
    the winner. NMS window: ±2 rotation samples × ±1 cell; a plateau
    passes whole (``vol >= pooled``), and among equal scores the lower
    flat index comes first (a stable descending sort)."""
    if grid is None:
        grid = build_likelihood_grid_points(
            ref_pts, ref_ok, res=res, half_extent=half_extent, blur_sigma=blur_sigma
        )
    thetas, n_steps, steps = _search_grid(init_pose, search_xy, search_theta, n_theta, res)
    vol = correlative_score_volume(
        grid, cur_pts, cur_ok, thetas, n_steps, res, half_extent,
        init_pose[:, :2], overlap_norm=overlap_norm,
    )                                                      # [B, K, Ty, Tx]
    with trace("h3_peak_nms"):
        # max_pool3d pads with -inf, as a "SAME" max window does.
        pooled = F.max_pool3d(vol[:, None], (5, 3, 3), stride=1, padding=(2, 1, 1))[:, 0]
        flat = torch.where(vol >= pooled, vol, -torch.inf).reshape(vol.shape[0], -1)
        srt = torch.sort(flat, dim=-1, descending=True, stable=True)
        scores, idx = srt.values[:, :n_peaks], srt.indices[:, :n_peaks]
    poses = _poses_at(init_pose, thetas, steps, idx)
    return poses, torch.where(torch.isfinite(scores), scores, 0.0)


def match_correlative_points(
    ref_pts: Tensor,
    ref_ok: Tensor,
    cur_pts: Tensor,
    cur_ok: Tensor,
    init_pose: Tensor,
    search_xy: float = 8.0,
    search_theta: float = 0.8,
    n_theta: int = 33,
    res: float = 0.3,
    half_extent: float = 20.0,
    blur_sigma: float = 1.0,
    min_score: float = MIN_SCORE,
) -> CorrelativeResult:
    """Coarse correlative match of masked point clouds ``[B, N, 2]``
    against references ``[B, M, 2]`` over ``±search_xy × ±search_theta``
    centered on ``init_pose [B, 3]``: the init-free front of loop
    closure, exhaustive over a drift-sized window. The result is
    cell-quantized; polish with ``match_icp_points`` for metric accuracy."""
    grid = build_likelihood_grid_points(
        ref_pts, ref_ok, res=res, half_extent=half_extent, blur_sigma=blur_sigma
    )
    thetas, n_steps, steps = _search_grid(init_pose, search_xy, search_theta, n_theta, res)
    score = correlative_score_volume(
        grid, cur_pts, cur_ok, thetas, n_steps, res, half_extent, init_pose[:, :2]
    ).reshape(init_pose.shape[0], -1)
    k = torch.argmax(score, dim=-1, keepdim=True)          # first on ties
    best = torch.gather(score, 1, k)[:, 0]
    pose = _poses_at(init_pose, thetas, steps, k)[:, 0]
    return CorrelativeResult(pose=pose, score=best, fail=best < min_score)
