"""Trajectory tracking and obstacle-aware speed control (port of
``nav/controller.py``).

A pure-pursuit waypoint chase, capped by the security zones: the space
in front of the robot is partitioned into 5 zones with per-zone speed
caps, and the nearest valid return inside the frontal cone picks the
zone. Every function works on the device of its inputs and issues no
host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import se2
from ..core.scan import LaserModel, Scan

Tensor = torch.Tensor

# Security zones: (range [m], max speed [m/s]) — nearest zone wins.
ZONES = ((0.3, 0.0), (0.6, 0.1), (1.0, 0.25), (1.5, 0.5), (2.5, 0.8))
FREE_SPEED = 1.0
ZONE_HALF_ANGLE = 1.0  # [rad] cone in front of the robot considered


class ControlCommand(NamedTuple):
    v: Tensor       # [] forward speed [m/s]
    omega: Tensor   # [] angular rate [rad/s]
    zone: Tensor    # [] int32 active security zone (-1 = free)


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


def pure_pursuit(
    pose: Tensor,
    path: Tensor,
    n_valid: Tensor | int,
    lookahead: float = 0.6,
    v_des: float = 0.8,
    k_omega: float = 2.0,
) -> tuple[Tensor, Tensor]:
    """Pure-pursuit waypoint chase: steer at the first point of ``path
    [K, 2]`` (its first ``n_valid`` rows are real) at least ``lookahead``
    ahead of the point closest to ``pose [3]``; past the end, at the last
    real point. Returns ``(v, omega)``."""
    n = path.shape[0]
    idx = torch.arange(n, device=path.device)
    live = idx < n_valid
    d = torch.linalg.vector_norm(path - pose[None, :2], dim=-1)
    d = torch.where(live, d, torch.inf)
    nearest = torch.argmin(d)
    ahead = (idx >= nearest) & live & (d >= lookahead)
    last = torch.as_tensor(n_valid, device=path.device) - 1
    target_idx = torch.where(torch.any(ahead), torch.argmax(ahead.to(torch.uint8)), last)
    target = path[torch.clamp(target_idx, 0, n - 1)]

    local = se2.transform_points(se2.inverse(pose), target[None, :])[0]
    angle = torch.atan2(local[1], local[0])
    v = v_des * torch.cos(torch.clamp(angle, -math.pi / 2, math.pi / 2))
    omega = k_omega * angle
    return torch.clamp(v, min=0.0), omega


def track_step(
    model: LaserModel,
    scan: Scan,
    pose: Tensor,
    path: Tensor,
    n_valid: Tensor | int,
    v_des: float = 0.8,
) -> ControlCommand:
    """One control tick: pure pursuit capped by the security zones."""
    v, omega = pure_pursuit(pose, path, n_valid, v_des=v_des)
    cap, zone = security_speed_cap(model, scan)
    return ControlCommand(v=torch.minimum(v, cap), omega=omega, zone=zone)
