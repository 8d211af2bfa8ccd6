"""Obstacle-aware speed control (port of the security-zone part of
``nav/controller.py``).

The space in front of the robot is partitioned into 5 security zones
with per-zone speed caps; the nearest valid return inside the frontal
cone picks the zone.
"""

from __future__ import annotations

import torch

from ..core.scan import LaserModel, Scan

Tensor = torch.Tensor

# Security zones: (range [m], max speed [m/s]) — nearest zone wins.
ZONES = ((0.3, 0.0), (0.6, 0.1), (1.0, 0.25), (1.5, 0.5), (2.5, 0.8))
FREE_SPEED = 1.0
ZONE_HALF_ANGLE = 1.0  # [rad] cone in front of the robot considered


def security_speed_cap(model: LaserModel, scan: Scan) -> tuple[Tensor, Tensor]:
    """Max safe forward speed ``[]`` and active zone ``[]`` int32 (-1 =
    free) from the live scan ``[N]``, on the scan's device."""
    r = scan.ranges
    fi = model.bearings(r.dtype, r.device)
    frontal = torch.abs(fi) < ZONE_HALF_ANGLE
    ok = frontal & ~scan.bad & (r > model.min_range)
    nearest = torch.min(torch.where(ok, r, torch.inf))

    # The zones' ranges ascend, so the zone is the count of zone ranges at
    # or below the nearest return; past the last zone the way is free.
    ranges = torch.tensor([z[0] for z in ZONES], dtype=r.dtype, device=r.device)
    caps = torch.tensor([z[1] for z in ZONES] + [FREE_SPEED], dtype=r.dtype, device=r.device)
    k = torch.sum(nearest >= ranges)
    zone = torch.where(k < len(ZONES), k, -1).to(torch.int32)
    return caps[k], zone
