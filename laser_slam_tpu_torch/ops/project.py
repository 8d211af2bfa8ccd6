"""Polar scan projection: resample a scan into another frame's bearing
grid (port of ``ops/project.py``, dense form).

One masked ``[..., N_pairs, N_bins]`` candidate matrix and a min-reduce
over pairs; the first pair reaching the minimum wins (its facing decides
occlusion).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.scan import LaserModel, Scan

Tensor = torch.Tensor

# Range value used for bins no surface projects into (10000 cm = 100 m).
EMPTY_RANGE = 100.0


class Projection(NamedTuple):
    """Current scan resampled at the reference scan's bearings."""

    new_r: Tensor      # [..., N] interpolated ranges, EMPTY_RANGE where empty
    empty: Tensor      # [..., N] bool: no surface crossed this bearing
    occluded: Tensor   # [..., N] bool: nearest crossing was back-facing

    @property
    def bad(self) -> Tensor:
        return self.empty | self.occluded


def _pair_valid_from_seg(scan: Scan) -> Tensor:
    """Adjacent beams (i-1, i) usable for interpolation: same nonzero
    segment, both good; pair 0 never."""
    seg, bad = scan.seg, scan.bad
    ok = (
        (seg != 0)
        & (seg == torch.roll(seg, 1, dims=-1))
        & ~bad
        & ~torch.roll(bad, 1, dims=-1)
    )
    ok[..., 0] = False
    return ok


class PairGeometry(NamedTuple):
    """Per-pair quantities of a posed scan; pair ``i`` spans beams
    ``(i-1, i)``. All fields ``[..., N]``."""

    ok: Tensor      # bool: usable for interpolation and narrower than pi
    lo: Tensor      # least bearing of the span
    hi: Tensor      # greatest bearing of the span
    occl: Tensor    # bool: back-facing span (equality counts)
    phi0: Tensor    # bearing of beam i-1
    dphi: Tensor    # bearing step, kept away from 0
    rr0: Tensor     # range of beam i-1
    drr: Tensor     # range step


def pair_geometry(model: LaserModel, scan: Scan, pose: Tensor) -> PairGeometry:
    """Transform ``scan [..., N]`` by ``pose [..., 3]`` into the target
    frame's polar coordinates and pair up adjacent beams."""
    r = scan.ranges
    fi = model.bearings(r.dtype, r.device)                     # [N]
    px, py, pth = pose[..., 0:1], pose[..., 1:2], pose[..., 2:3]

    ang = pth + fi
    x = r * torch.cos(ang) + px
    y = r * torch.sin(ang) + py
    rr = torch.sqrt(x * x + y * y)
    phi = torch.atan2(y, x)
    # Third-quadrant lift keeps 270°-FOV scans continuous across ±pi.
    phi = torch.where((x < 0) & (y < 0), phi + 2.0 * math.pi, phi)

    phi0 = torch.roll(phi, 1, dims=-1)
    rr0 = torch.roll(rr, 1, dims=-1)
    dphi = phi - phi0
    return PairGeometry(
        ok=_pair_valid_from_seg(scan) & (torch.abs(dphi) < math.pi),
        lo=torch.minimum(phi0, phi),
        hi=torch.maximum(phi0, phi),
        occl=phi <= phi0,
        phi0=phi0,
        dphi=torch.where(torch.abs(dphi) < 1e-9, 1e-9, dphi),
        rr0=rr0,
        drr=rr - rr0,
    )


def project_dense(fi: Tensor, g: PairGeometry) -> Projection:
    """Resample the pairs ``g`` at the bearings ``fi [N]``: per bin the
    least interpolated range over the pairs that cover it, the first
    such pair deciding occlusion."""
    # Candidate matrix over (pair i, bearing bin j).
    mask = (fi >= g.lo[..., :, None]) & (fi <= g.hi[..., :, None])
    mask &= g.ok[..., :, None]                                 # [..., N, N]
    t = (fi - g.phi0[..., :, None]) / g.dphi[..., :, None]
    ri = g.rr0[..., :, None] + g.drr[..., :, None] * t         # [..., N, N]

    ri_masked = torch.where(mask, ri, EMPTY_RANGE)
    new_r, winner = torch.min(ri_masked, dim=-2)               # first argmin
    empty = ~torch.any(mask, dim=-2)
    occluded = torch.gather(g.occl, -1, winner) & ~empty
    new_r = torch.where(empty, EMPTY_RANGE, new_r)
    return Projection(new_r=new_r, empty=empty, occluded=occluded)


def scan_project(model: LaserModel, scan: Scan, pose: Tensor) -> Projection:
    """Project ``scan [..., N]`` posed at ``pose [..., 3]`` (relative to
    the target frame) onto the target's bearing grid."""
    fi = model.bearings(scan.ranges.dtype, scan.ranges.device)
    return project_dense(fi, pair_geometry(model, scan, pose))
