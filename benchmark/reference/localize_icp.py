"""Reference of ray-cast + ICP localization, the reference C++'s own
``CParticles::update`` → ``CVPmap::obsLikelyhood`` (particles.cpp:321-387,
VPmap.cpp:485-503): for every particle the expected scan is ray-cast from
the map (``laserScanSimulator``, VPmap.cpp:180-300), the real scan is
aligned onto it by point ICP (``ICPMatch``, ZHIcp_Warpper.cpp:125-161),
the weight is the match's goodness and the particle moves to the
corrected pose. Composed of the frozen plain modules: the dense ladder
``raycast.simulate_scan`` in chunks of ``CHUNK_BYTES``, ``match_icp_points``
in the chunks of the frozen ``update_icp``, and the filter's phases.

Departures from the C++:
- The ICP is the port's trimmed point-to-segment ICP for a fixed 10
  iterations from a 0.6 m gate (``update_icp``'s settings); the C++ runs
  MRPT's ``icpClassic`` for up to 100 iterations and stops when it
  converges.
- The simulated scan is the ladder's first occupied sample at the map's
  resolution (a hit to within one cell), its world points only where the
  simulated range is below the sensor's maximum.
- The likelihood of a failed match (fewer than 20 points matched) is
  ``1e-6``.
- The cell runs 4096 particles; the C++ tracked with 60.

``lap`` runs the first ``check_ticks`` ticks of a lap as
``localize_beam.lap`` does. TF32 is off: the float32 comparison holds
float32 math."""

from __future__ import annotations

import numpy as np
import torch

from .localize_beam import setup
from .slam.core import se2
from .slam.core.scan import Scan
from .slam.localization import particle_filter as pf
from .slam.localization.raycast import SIMULATE_BYTES_PER_SAMPLE, simulate_scan
from .slam.ops.icp_points import match_icp_points, scan_to_points


def update(state, grid, model, ranges, valid, nudge: bool = True, iters: int = 10,
           max_corr: float = 0.6):
    """The ray-cast + ICP update of ``state`` against the observed scan
    ``ranges [N]`` (beams ``valid`` and inside the sensor's range)."""
    p, n = state.poses.shape[0], model.n_beams
    n_samples = int(model.max_range / grid.spec.resolution)
    march = pf._chunk(p, n * n_samples * SIMULATE_BYTES_PER_SAMPLE, None)
    sim = torch.cat([simulate_scan(grid, model, state.poses[i:i + march])
                     for i in range(0, p, march)])
    fi = model.bearings(ranges.dtype, ranges.device)
    ang = state.poses[:, 2:3] + fi
    sim_pts = torch.stack([state.poses[:, 0:1] + sim * torch.cos(ang),
                           state.poses[:, 1:2] + sim * torch.sin(ang)], dim=-1)
    sim_ok = sim < model.max_range
    scan_pts, scan_ok = scan_to_points(model, Scan(ranges, ~valid, None))
    step = pf._chunk(p, n * n * pf.ICP_BYTES_PER_PAIR, None)
    res = []
    for i in range(0, p, step):
        b = min(step, p - i)
        res.append(match_icp_points(sim_pts[i:i + b], sim_ok[i:i + b], scan_pts.expand(b, n, 2),
                                    scan_ok.expand(b, n), state.poses[i:i + b],
                                    iters=iters, max_corr=max_corr))
    fail = torch.cat([r.fail for r in res])
    lik = torch.where(fail, 1e-6, torch.cat([r.goodness for r in res]))
    moved = torch.cat([r.pose for r in res])
    poses = torch.where(fail[:, None], state.poses, moved) if nudge else state.poses
    return pf._reweight(state, lik, poses)


def lap(log, split: int, loc: dict, draws: dict, check_ticks: int, device,
        dtype=torch.float32, visit=None) -> tuple[np.ndarray, np.ndarray]:
    """The first ``check_ticks`` ticks of a lap over the second half from
    the ground-truth pose at ``split``, with the configuration's
    localization block ``loc``: the estimate of every tick ``[L, 3]`` and
    the map's log-odds. ``visit(k, before, after, (grid, model, ranges,
    valid))``, where given, sees each tick's cloud before and after the
    update."""
    model, scans, gt, grid = setup(log, split, float(loc["resolution"]), device, dtype)
    sigma = (float(loc["predict_sigma_xy"]), float(loc["predict_sigma_theta"]))
    state = pf.init_from_noise(gt[split], draws["init_xy"].to(dtype), draws["init_t"].to(dtype))
    ests = []
    for k, t in enumerate(range(split + 1, min(split + 1 + check_ticks, log.ranges.shape[0]))):
        rel = se2.relative(gt[t - 1], gt[t])
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        state = pf.predict_with_noise(state, rel, draws["xy"][k].to(dtype),
                                      draws["t"][k].to(dtype), *sigma)
        after = update(state, grid, model, scans.ranges[t], valid, bool(loc["nudge"]),
                       int(loc["icp_iters"]), float(loc["icp_max_corr"]))
        if visit is not None:
            visit(k, state, after, (grid, model, scans.ranges[t], valid))
        state = pf.maybe_resample_at(after, draws["u"][k].to(dtype))
        ests.append(pf.estimate(state))
    return torch.stack(ests).float().cpu().numpy(), grid.log_odds.float().cpu().numpy()
