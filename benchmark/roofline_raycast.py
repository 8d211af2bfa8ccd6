"""The least work of the ray-cast beam model's march, whatever implements
it, reckoned from the log and the mix alone.

A beam needs the samples up to its observed range, ``ceil(min(r, r_max)
/ res)``, and a beam with no valid return the whole ladder ``S =
r_max / res`` (``int``, as the program's ladder). Each sample costs
``OPS_PER_SAMPLE`` operations: its two coordinates (a multiply-add
each), its two cell indices (subtract, scale, floor each), four bounds
tests, the flat index (a multiply-add) and the occupancy test. A tick
reads the grid's log-odds and the cloud once and writes one likelihood
a particle. The peaks are ``roofline.py``'s.
"""

from __future__ import annotations

import numpy as np

# 2 + 2 (coordinates) + 3 + 3 (cell indices) + 4 (bounds) + 2 (flat
# index) + 1 (occupancy test).
OPS_PER_SAMPLE = 17


def ladder(max_range: float, resolution: float) -> int:
    """``S``, the samples of the program's dense ladder a beam."""
    return int(max_range / resolution)


def samples_per_scan(ranges: np.ndarray, min_range: float, max_range: float,
                     resolution: float) -> np.ndarray:
    """Samples each scan's beams need, summed over the beams ``[T]``, for
    raw ranges ``[T, N]``: a valid return (``min_range < r < max_range``)
    up to its range, any other beam the whole ladder."""
    r = np.asarray(ranges, np.float64)
    s = ladder(max_range, resolution)
    valid = (r > min_range) & (r < max_range)
    need = np.where(valid, np.ceil(np.minimum(r, max_range) / resolution), s)
    return np.minimum(need, s).astype(np.int64).sum(axis=-1)


def march_ops(particle_samples: int) -> float:
    """Operations of ``particle_samples`` (particles × samples) samples."""
    return float(OPS_PER_SAMPLE) * particle_samples


def tick_bytes(grid_cells: int, particles: int, n_beams: int) -> float:
    """Bytes a tick reads and writes once: the grid's float32 log-odds,
    the cloud's float32 poses, the scan's ranges (float32) and valid mask
    (bool), and a float32 likelihood a particle."""
    return 4.0 * grid_cells + 12.0 * particles + 5.0 * n_beams + 4.0 * particles

