"""Scan preprocessing: median filter, far-point tagging, segmentation
(port of ``ops/preprocess.py``). All functions act on ``[..., N]``."""

from __future__ import annotations

import torch

from ..core.scan import LaserModel, Scan

Tensor = torch.Tensor

SEG_MAX_DIST = 0.20      # [m] max range gap inside one segment
MEDIAN_HALF_WINDOW = 2


def median_filter(ranges: Tensor, half_window: int = MEDIAN_HALF_WINDOW) -> Tensor:
    """Window-(2h+1) median along the last axis with edge clamping."""
    n = ranges.shape[-1]
    idx = torch.arange(n, device=ranges.device)
    cols = [
        ranges[..., (idx + d).clamp(0, n - 1)]
        for d in range(-half_window, half_window + 1)
    ]
    stacked = torch.stack(cols, dim=-1)            # [..., N, W]
    return torch.sort(stacked, dim=-1).values[..., half_window].contiguous()


def far_point_mask(ranges: Tensor, model: LaserModel) -> Tensor:
    return ranges > model.max_range


def pair_connected(ranges: Tensor, bad: Tensor, max_dist: float = SEG_MAX_DIST) -> Tensor:
    """``[..., N]`` bool: entry ``i`` is True iff beams ``i-1`` and ``i``
    belong to the same segment (entry 0 is always False): a small range
    gap, or a collinear continuation of the two previous good beams."""
    r = ranges
    good = ~bad
    r_m1 = torch.roll(r, 1, dims=-1)
    r_m2 = torch.roll(r, 2, dims=-1)
    close = torch.abs(r - r_m1) < max_dist
    extrap = torch.abs(r - (2.0 * r_m1 - r_m2)) < max_dist

    both_good = good & torch.roll(good, 1, dims=-1)
    three_good = both_good & torch.roll(good, 2, dims=-1)
    c = (both_good & close) | (three_good & extrap)
    # Pair 0 does not exist; pair 1 has no extrapolation history.
    c[..., 0] = False
    c[..., 1] = (both_good & close)[..., 1]
    return c


def segment_ids(pair_ok: Tensor) -> Tensor:
    """Integer segment labels from the pair relation; singletons get 0."""
    breaks = (~pair_ok).to(torch.int32)
    raw = torch.cumsum(breaks, dim=-1, dtype=torch.int32)
    has_right = torch.zeros_like(pair_ok)
    has_right[..., :-1] = pair_ok[..., 1:]
    singleton = ~(pair_ok | has_right)
    return torch.where(singleton, torch.zeros_like(raw), raw + 1)


def preprocess(ranges: Tensor, model: LaserModel) -> Scan:
    """Full preprocessing chain → :class:`Scan` (pm_preprocessScan)."""
    r = median_filter(ranges)
    bad = far_point_mask(r, model) | (r < model.min_range)
    pair_ok = pair_connected(r, bad)
    seg = segment_ids(pair_ok)
    return Scan(ranges=r, bad=bad, seg=seg)


def preprocess_log(ranges: Tensor, model: LaserModel) -> Scan:
    """Preprocess a whole ``[T, N]`` log in one batched call."""
    return preprocess(ranges, model)
