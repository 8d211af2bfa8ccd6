"""Multiscale interest-point detection on the range curve (port of
``features/detector.py``), batched over scans.

Blob detection as in FLIRT's default configuration (``scale = 5``,
``baseSigma = 0.2``, ``sigmaStep = 1.4``, ``minPeak = 0.34``): extrema of
the difference of Gaussians of the range signal across bearing *and*
scale. The scale space of a batch is one ``[B, S+1, N]`` tensor built by
masked 1D convolutions; the extrema are a 3-neighbourhood mask; each scan
keeps a fixed ``K`` strongest responses with a validity mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.scan import LaserModel, Scan

Tensor = torch.Tensor

N_SCALES = 5
BASE_SIGMA = 0.2
SIGMA_STEP = 1.4
MIN_PEAK = 0.34
MAX_FEATURES = 32  # fixed feature budget per scan


class FeatureSet(NamedTuple):
    """Fixed-shape sets of ``K`` interest points, ``[B, K, ...]``."""

    xy: Tensor       # [B, K, 2] position in the sensor frame (meters)
    scale: Tensor    # [B, K] detection scale
    score: Tensor    # [B, K] detector response (higher = stronger)
    beam: Tensor     # [B, K] int32 source beam index, -1 where not valid
    valid: Tensor    # [B, K] bool


def _gaussian_kernel(sigma_bins: float, radius: int, dtype, device) -> Tensor:
    x = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    k = torch.exp(-0.5 * (x / sigma_bins) ** 2)
    return k / torch.sum(k)


def _smooth(signal: Tensor, weight_ok: Tensor, sigma_bins: float, radius: int) -> Tensor:
    """Mask-aware Gaussian smoothing of ``[B, N]`` rows (normalized
    convolution): invalid beams weigh zero instead of poisoning their
    neighbours. The kernel is symmetric, so correlation is convolution."""
    k = _gaussian_kernel(sigma_bins, radius, signal.dtype, signal.device)[None, None]
    s = F.conv1d((signal * weight_ok)[:, None], k, padding=radius)[:, 0]
    w = F.conv1d(weight_ok[:, None], k, padding=radius)[:, 0]
    return s / torch.clamp(w, min=1e-6)


def detect_features(
    model: LaserModel,
    scan: Scan,
    k_features: int = MAX_FEATURES,
    min_peak: float = MIN_PEAK,
) -> FeatureSet:
    """Up to ``k_features`` blob interest points on each scan ``[B, N]``:

    1. Gaussian scale space of the range curve, sigmas
       ``baseSigma · sigmaStep^s`` in radians of surface at a nominal 3 m
       range, converted to bearing bins;
    2. the difference of adjacent smoothing levels;
    3. local extrema over the 3-neighbourhood in bearing and scale, with a
       response ≥ ``min_peak`` × the response's std, on good beams;
    4. the strongest ``K`` (a stable sort: the lower flat index first
       among equals) with a validity mask.
    """
    n = model.n_beams
    dtype, dev = scan.ranges.dtype, scan.ranges.device
    ok = (~scan.bad).to(dtype)                                    # [B, N]
    r = torch.where(scan.bad, 0.0, scan.ranges)

    bin_len = 3.0 * model.dfi
    sigmas = [BASE_SIGMA * SIGMA_STEP ** s for s in range(N_SCALES + 1)]
    sig_bins = [max(s / bin_len, 0.6) for s in sigmas]
    radius = min(int(math.ceil(3 * max(sig_bins))), n // 2)
    levels = torch.stack([_smooth(r, ok, sb, radius) for sb in sig_bins], dim=1)   # [B, S+1, N]
    dog = levels[:, 1:] - levels[:, :-1]                          # [B, S, N]

    # 3-neighbourhood extrema in bearing (cyclic, as the reference's
    # roll) and in scale (clamped at the ends).
    left = torch.roll(dog, 1, dims=2)
    right = torch.roll(dog, -1, dims=2)
    up = torch.cat([dog[:, 1:], dog[:, -1:]], dim=1)
    dn = torch.cat([dog[:, :1], dog[:, :-1]], dim=1)
    is_max = (dog > left) & (dog > right) & (dog >= up) & (dog >= dn)
    is_min = (dog < left) & (dog < right) & (dog <= up) & (dog <= dn)

    resp = torch.abs(dog)
    okb = ok[:, None, :].expand_as(dog)
    mean = torch.sum(dog * okb, dim=(1, 2)) / torch.sum(okb, dim=(1, 2))
    std = torch.sqrt(
        torch.sum(ok[:, None, :] * (dog - mean[:, None, None]) ** 2, dim=(1, 2))
        / torch.clamp(torch.sum(ok, dim=1) * N_SCALES, min=1.0))
    thresh = min_peak * torch.clamp(std, min=1e-6)

    i = torch.arange(n, device=dev)
    interior = (i > 0) & (i < n - 1)
    cand = (is_max | is_min) & (resp > thresh[:, None, None]) & ~scan.bad[:, None, :] & interior

    flat = torch.where(cand, resp, -torch.inf).reshape(resp.shape[0], -1)
    top = torch.sort(flat, dim=-1, descending=True, stable=True)
    score, idx = top.values[:, :k_features], top.indices[:, :k_features]
    valid = torch.isfinite(score)

    beam = idx % n
    scale_i = idx // n
    scale = torch.tensor(sigmas, dtype=dtype, device=dev)[torch.clamp(scale_i + 1, 0, N_SCALES)]
    fi = model.bearings(dtype, dev)[beam]
    rng = torch.gather(scan.ranges, 1, beam)
    xy = torch.stack([rng * torch.cos(fi), rng * torch.sin(fi)], dim=-1)
    return FeatureSet(
        xy=torch.where(valid[..., None], xy, 0.0),
        scale=torch.where(valid, scale, 0.0),
        score=torch.where(valid, score, 0.0),
        beam=torch.where(valid, beam, -1).to(torch.int32),
        valid=valid,
    )
