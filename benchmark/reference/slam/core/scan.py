"""Scan containers and laser sensor models (port of ``core/scan.py``).

Scans are batched tensors ``[..., N]`` with boolean masks. Units are
meters / radians everywhere.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class LaserModel:
    """Static description of a 2D laser range finder (hashable)."""

    name: str
    n_beams: int              # pm_l_points
    fov_deg: float            # pm_fov
    fi_min_deg: float         # start bearing, degrees
    max_range: float          # [m] pm_max_range
    min_range: float = 0.10   # [m] PM_MIN_RANGE (10 cm)
    min_valid_points: int = 40
    window: int = 20          # pm_scan_window: half-window in bearing bins

    @property
    def fi_min(self) -> float:
        return math.radians(self.fi_min_deg)

    @property
    def dfi(self) -> float:
        """Angular resolution [rad]: fov / (n_beams - 1)."""
        return math.radians(self.fov_deg) / (self.n_beams - 1.0)

    def with_start(self, fi_min_rad: float, max_range: float | None = None) -> "LaserModel":
        """Override start bearing / max range from a log header."""
        return dataclasses.replace(
            self,
            fi_min_deg=math.degrees(fi_min_rad),
            max_range=self.max_range if max_range is None else max_range,
        )

    def bearings(self, dtype=torch.float32, device=None) -> Tensor:
        """``[N]`` beam bearing angles, ``i·dfi + fi_min`` in ``dtype``."""
        i = torch.arange(self.n_beams, dtype=dtype, device=device)
        return i * self.dfi + self.fi_min


# Laser presets, ranges in meters.
LMS211 = LaserModel("LMS211", 181, 180.0, -90.0, 50.0, min_valid_points=40, window=20)
LMS511 = LaserModel("LMS511", 361, 180.0, 0.0, 50.0, min_valid_points=80, window=40)
LMS151 = LaserModel("LMS151", 541, 270.0, -45.0, 50.0, min_valid_points=100, window=50)

PRESETS = {m.name: m for m in (LMS211, LMS511, LMS151)}


class Scan(NamedTuple):
    """A (batch of) preprocessed polar scan(s); all fields ``[..., N]``."""

    ranges: Tensor   # [..., N] float32, meters
    bad: Tensor      # [..., N] bool — far / short / otherwise invalid
    seg: Tensor      # [..., N] int32 segment ids; 0 means "no segment"

    @property
    def n_beams(self) -> int:
        return self.ranges.shape[-1]

    def points(self, model: LaserModel) -> Tensor:
        """``[..., N, 2]`` Cartesian points in the sensor frame."""
        fi = model.bearings(self.ranges.dtype, self.ranges.device)
        return torch.stack([self.ranges * torch.cos(fi), self.ranges * torch.sin(fi)], dim=-1)

    def to(self, device) -> "Scan":
        return Scan(*(x.to(device) for x in self))


def stack_scans(scans: list[Scan]) -> Scan:
    """``T`` scans ``[N]`` as one batch ``[T, N]``."""
    return Scan(*(torch.stack(x) for x in zip(*scans)))


def raw_scan(ranges: Tensor, model: LaserModel) -> Scan:
    """An unpreprocessed :class:`Scan` from raw ranges [m]; readings
    below ``min_range`` are pushed beyond ``max_range`` so the far-point
    filter tags them."""
    ranges = torch.as_tensor(ranges)
    ranges = torch.where(
        ranges < model.min_range,
        torch.full_like(ranges, model.max_range + 1.0),
        ranges,
    )
    return Scan(
        ranges=ranges,
        bad=torch.zeros(ranges.shape, dtype=torch.bool, device=ranges.device),
        seg=torch.zeros(ranges.shape, dtype=torch.int32, device=ranges.device),
    )


def pad_beams(ranges: np.ndarray, n_beams: int, fill: float) -> np.ndarray:
    """Pad a ``[T, M]`` range array up to ``n_beams`` with ``fill``
    (180-beam logs pad to the 181-beam model)."""
    t, m = ranges.shape
    if m >= n_beams:
        return ranges[:, :n_beams]
    out = np.full((t, n_beams), fill, dtype=ranges.dtype)
    out[:, :m] = ranges
    return out
