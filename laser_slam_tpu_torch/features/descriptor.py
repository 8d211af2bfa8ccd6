"""Beta-grid style polar descriptors and the symmetric-χ² distance (port
of ``features/descriptor.py``), batched over scans.

A descriptor is a polar histogram of the scan points around an interest
point (radial × angular bins between ``MIN_RHO`` and ``MAX_RHO``), the
angles measured from the feature's bearing, normalized to sum 1.
"""

from __future__ import annotations

import math

import torch

from ..core.scan import LaserModel, Scan
from .detector import FeatureSet

Tensor = torch.Tensor

MIN_RHO = 0.02
MAX_RHO = 0.5
N_RADIAL = 4
N_ANGULAR = 8
DESCRIPTOR_DIM = N_RADIAL * N_ANGULAR


def describe_features(model: LaserModel, scan: Scan, feats: FeatureSet) -> Tensor:
    """``[B, K, D]`` normalized polar histograms around each feature of
    the scans ``[B, N]``. Angular bins are measured from the feature's
    bearing from the sensor, so the descriptor does not depend on the
    sensor's pose."""
    dtype, dev = scan.ranges.dtype, scan.ranges.device
    fi = model.bearings(dtype, dev)
    pts = torch.stack([scan.ranges * torch.cos(fi), scan.ranges * torch.sin(fi)], dim=-1)
    good = ~scan.bad                                              # [B, N]

    d = pts[:, None, :, :] - feats.xy[:, :, None, :]              # [B, K, N, 2]
    rho = torch.sqrt(torch.sum(d * d, dim=-1))
    view = torch.atan2(feats.xy[..., 1], feats.xy[..., 0])        # [B, K]
    ang = torch.atan2(d[..., 1], d[..., 0]) - view[..., None]
    ang = torch.remainder(ang, 2.0 * math.pi)                     # [0, 2π)
    in_range = (rho >= MIN_RHO) & (rho <= MAX_RHO) & good[:, None, :]

    r_edges = torch.linspace(MIN_RHO, MAX_RHO, N_RADIAL + 1, dtype=dtype, device=dev)
    r_bin = torch.clamp(torch.searchsorted(r_edges, rho.contiguous(), right=True) - 1,
                        0, N_RADIAL - 1)
    a_bin = torch.clamp((ang / (2.0 * math.pi / N_ANGULAR)).to(torch.int32), 0, N_ANGULAR - 1)
    bin_idx = r_bin * N_ANGULAR + a_bin                           # [B, K, N]

    hist = torch.zeros(*bin_idx.shape[:2], DESCRIPTOR_DIM, dtype=dtype, device=dev)
    hist.scatter_add_(2, bin_idx.long(), in_range.to(dtype))
    hist = hist / torch.clamp(torch.sum(hist, dim=-1, keepdim=True), min=1.0)
    return torch.where(feats.valid[..., None], hist, 0.0)


def descriptor_distance(da: Tensor, db: Tensor) -> Tensor:
    """Symmetric χ² distance between all descriptor pairs: ``da [..., Ka,
    D]``, ``db [..., Kb, D]`` → ``[..., Ka, Kb]``."""
    a, b = da[..., :, None, :], db[..., None, :, :]
    num = (a - b) ** 2
    den = a + b
    return 0.5 * torch.sum(torch.where(den > 1e-12, num / torch.clamp(den, min=1e-12), 0.0), dim=-1)
