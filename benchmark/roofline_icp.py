"""The least work of the ray-cast + ICP model's search, whatever
implements it, reckoned from the log and the mix alone.

Every iteration of every particle's match looks, for each valid point of
the observed scan, at each of the ``N`` points of the particle's
simulated scan for the nearest two: ``OPS_PER_PAIR`` operations a pair,
as the plain brute-force search computes it. Each valid point then costs
``OPS_PER_POINT`` operations of the iteration's update. A scan's valid
points are its returns inside the sensor's range, ``min_range < r <
max_range``, known on the host from the raw log; every simulated point
is counted, since which of them hit the map is known only on the device.
The bytes are the clouds read once an iteration: each particle's
simulated points (two float32 and a mask byte each), the observed scan's
once, and each particle's pose read and written. The peaks are
``roofline.py``'s.
"""

from __future__ import annotations

import numpy as np

# 2 (coordinate differences) + 3 (squared distance) + 1 (the validity
# select) + 2 (the nearest and second-nearest comparisons).
OPS_PER_PAIR = 8
# 8 (the point's transform) + 5 (segment and its squared length) + 8
# (projection parameter and its clamp) + 6 (projected point, target) +
# 13 (distances to the projection and to the nearest point, the select)
# + 3 (gate, match) + 11 (trim: the sort key, ~log2(361) comparisons of
# the sort, the keep test) + 23 (the alignment's sums: weight, both
# centroids, the centred products, the four cross sums, the error).
OPS_PER_POINT = 77
# Bytes a simulated or observed point: two float32 coordinates and a mask.
POINT_BYTES = 4 + 4 + 1


def scan_points(ranges: np.ndarray, min_range: float, max_range: float) -> np.ndarray:
    """Valid points of each scan ``[T]`` of raw ranges ``[T, N]``."""
    r = np.asarray(ranges, np.float64)
    return ((r > min_range) & (r < max_range)).sum(axis=-1).astype(np.int64)


def search_ops(particle_points: int, n_sim: int, iters: int) -> float:
    """Operations of ``particle_points`` (particles × valid observed
    points, summed over ticks) matched against ``n_sim`` simulated points
    a particle for ``iters`` iterations."""
    return float(iters) * particle_points * (n_sim * OPS_PER_PAIR + OPS_PER_POINT)


def tick_bytes(particles: int, n_beams: int, iters: int) -> float:
    """Bytes a tick's search reads and writes once an iteration."""
    return float(iters) * (particles * n_beams * POINT_BYTES + n_beams * POINT_BYTES
                           + particles * 24)
