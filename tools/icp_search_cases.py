"""Inputs of the point-ICP nearest-two search
(``ops/icp_points._nearest_two``), for its kernel's CPU tests
(``tests/test_torch_icp_nearest.py``) and card tests
(``tests/test_torch_cuda.py -k nearest_two``).

- :func:`edge_cases`: rows with ties, no candidate, one candidate, points
  that are not finite, masked points of any value.
- :func:`scan_clouds`: observed and reference clouds in scan order.
- :func:`cell_clouds`: one tick's clouds of the ray-cast + ICP cell, as
  ``particle_filter.update_raycast_icp`` builds them.

Import it with this directory on ``sys.path``, as :mod:`synthetic_log`.
"""

from __future__ import annotations

import numpy as np
import torch

from laser_slam_tpu_torch.core import se2
from laser_slam_tpu_torch.core.scan import Scan
from laser_slam_tpu_torch.localization import raycast
from laser_slam_tpu_torch.ops.icp_points import scan_to_points

F = np.float32


def edge_cases():
    """``(q [8, 9, 2], ref [8, 11, 2], ok [8, 11])``, float32 and bool: row
    0 a point on three equal valid reference points (2, 5, 8), row 1 every
    reference point the same, row 2 no candidate, row 3 one (6), row 4
    observed points NaN or infinite (1-3), row 5 a valid reference point
    that is NaN (4), row 6 one at infinity (7), row 7 every reference point
    NaN but two valid ones (3, 9)."""
    rng = np.random.default_rng(7)
    b, n, m = 8, 9, 11
    q = rng.normal(0, 1, (b, n, 2)).astype(F)
    ref = rng.normal(0, 1, (b, m, 2)).astype(F)
    ok = rng.random((b, m)) > 0.2
    ref[0, 5] = ref[0, 2]
    ref[0, 8] = ref[0, 2]
    ok[0, [2, 5, 8]] = True
    q[0, 3] = ref[0, 2]
    ref[1] = ref[1, 0]
    ok[1] = True
    ok[2] = False
    ok[3] = False
    ok[3, 6] = True
    q[4, 1] = (np.nan, 0.0)
    q[4, 2] = (np.inf, 1.0)
    q[4, 3] = (-np.inf, np.inf)
    ref[5, 4] = (np.nan, 0.5)
    ok[5, 4] = True
    q[5, 0] = ref[5, 1]
    ref[6, 7] = (np.inf, 0.0)
    ok[6, 7] = True
    ref[7, :] = np.nan
    ok[7] = False
    ok[7, [3, 9]] = True
    ref[7, [3, 9]] = ((0.5, 0.5), (0.25, -1.0))
    return q, ref, ok


def scan_clouds(b: int, n: int, m: int, seed: int):
    """``(q [b, n, 2], ref [b, m, 2], ok [b, m])``: two clouds in scan order
    (each a fan of points by bearing over 180 degrees, 1-8 m), a tenth of
    the reference masked."""
    rng = np.random.default_rng(seed)
    ang_q = np.linspace(-np.pi / 2, np.pi / 2, n)
    ang_r = np.linspace(-np.pi / 2, np.pi / 2, m)
    r_q = rng.uniform(1.0, 8.0, (b, n))
    r_r = rng.uniform(1.0, 8.0, (b, m))
    q = np.stack([r_q * np.cos(ang_q), r_q * np.sin(ang_q)], -1).astype(F)
    ref = np.stack([r_r * np.cos(ang_r), r_r * np.sin(ang_r)], -1).astype(F)
    return q, ref, rng.random((b, m)) > 0.1


def cell_clouds(grid, model, poses, ranges, valid):
    """One tick's clouds of ``update_raycast_icp`` at the poses
    ``[P, 3]``: ``(sim_pts [P, N, 2], sim_ok [P, N], scan_pts [P, N, 2],
    scan_ok [P, N], q [P, N, 2])``, the simulated scans' hits, the observed
    scan expanded over the cloud and the observed points moved by each
    pose (the first iteration's search input)."""
    n, p = model.n_beams, poses.shape[0]
    sim = raycast.simulate_scan(grid, model, poses)
    ang = poses[:, 2:3] + model.bearings(ranges.dtype, ranges.device)
    sim_pts = torch.stack([poses[:, 0:1] + sim * torch.cos(ang),
                           poses[:, 1:2] + sim * torch.sin(ang)], dim=-1)
    scan_pts, scan_ok = scan_to_points(model, Scan(ranges, ~valid, None))
    scan_pts, scan_ok = scan_pts.expand(p, n, 2), scan_ok.expand(p, n)
    return (sim_pts, sim < model.max_range, scan_pts, scan_ok,
            se2.transform_points(poses, scan_pts))
