"""Beacon-based positioning (port of ``app/beacon.py``): a robot-mounted
receiver ranges a set of surveyed beacons; position comes from
trilateration, a fixed-shape masked Gauss-Newton over ``[M]`` range
residuals on the inputs' device, with no host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

Tensor = torch.Tensor


class BeaconFix(NamedTuple):
    xy: Tensor      # [2] estimated position
    err: Tensor     # [] RMS range residual [m]
    fail: Tensor    # [] bool — fewer than 3 usable beacons or divergence


def trilaterate(
    beacons: Tensor,
    ranges: Tensor,
    valid: Tensor,
    init_xy: Tensor | None = None,
    iters: int = 10,
) -> BeaconFix:
    """Least-squares position from ranges to known beacons.

    ``beacons [M, 2]``, ``ranges [M]``, ``valid [M]`` bool. Needs ≥ 3
    usable beacons for a unique fix (2 leaves a mirror ambiguity)."""
    dtype = ranges.dtype
    w = valid.to(dtype)
    n = torch.sum(w)
    fail = n < 3

    if init_xy is None:
        init_xy = torch.sum(beacons * w[:, None], dim=0) / torch.clamp(n, min=1.0)
    init_xy = init_xy.to(dtype)

    xy = init_xy
    eye = 1e-9 * torch.eye(2, dtype=dtype, device=ranges.device)
    for _ in range(iters):
        d = xy[None, :] - beacons                      # [M, 2]
        dist = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-6)
        resid = dist - ranges                          # [M]
        J = d / dist[:, None]                          # [M, 2]
        Jw = J * w[:, None]
        H = Jw.T @ J + eye
        g = Jw.T @ resid
        xy = xy - torch.linalg.solve_ex(H, g)[0]

    dist = torch.linalg.vector_norm(xy[None, :] - beacons, dim=-1)
    err = torch.sqrt(torch.sum(w * (dist - ranges) ** 2) / torch.clamp(n, min=1.0))
    fail = fail | ~torch.all(torch.isfinite(xy))
    xy = torch.where(fail, init_xy, xy)
    return BeaconFix(xy=xy, err=torch.where(fail, torch.inf, err), fail=fail)


def heading_from_fixes(prev_xy: Tensor, xy: Tensor, min_move: float = 0.05) -> Tensor:
    """Heading from two consecutive fixes; NaN when the motion is too
    small to be directionally meaningful."""
    d = xy - prev_xy
    th = torch.atan2(d[1], d[0])
    return torch.where(torch.linalg.vector_norm(d) < min_move, math.nan, th)
