"""Reference of global relocalization, the reference C++'s own
``threadLocalization::globalize`` → ``globalization``
(localization.cpp:483-540): ``g_num_of_global_particles`` = 10,000 random
valid poses (globaldef.cpp:13), each scored by ``CVPmap::obsLikelyhood``
(VPmap.cpp:485-503: the expected scan ray-cast from the map, the real
scan aligned onto it by ICP, the goodness as the weight, the pose
corrected), the best kept. Composed of ``localize_icp.update`` (the
frozen dense ladder, ``match_icp_points`` in the frozen ``update_icp``'s
chunks, the frozen weights) and the frozen filter's ``estimate``, with a
free-cell table and a sampler of its own.

Departures from the C++:
- Valid poses are drawn without rejection: a cell uniformly from the
  table of cells whose log-odds lie below 0, a position uniform inside it
  less ``MARGIN`` of its side at each edge, a heading uniform in
  ``[-π, π)``. The C++ draws poses over the map and rejects those that
  are not valid: the same distribution, but for the margin.
- The scoring's departures are ``localize_icp``'s: 10 fixed ICP
  iterations from a 0.6 m gate, a hit to within one cell, ``1e-6`` for a
  failed match.
- The best ``n_keep`` (4096 in the cell) are kept, by a stable
  descending sort of the log-weights, so the lower index wins among
  equals; the C++ hands its top-K to a 60-particle tracker.

``lap`` runs the first ``check_ticks`` ticks of a lap: each relocalizes
from the tick's uniforms alone, with no prior. TF32 is off
(``localize_beam.setup``): the float32 comparison holds float32 math."""

from __future__ import annotations

import math

import numpy as np
import torch

from .localize_beam import setup
from .localize_icp import update
from .slam.localization import particle_filter as pf

# The share of a cell's side left out at each edge by the sampler.
MARGIN = 0.01


def free_cells(log_odds: torch.Tensor) -> torch.Tensor:
    """Flat row-major indices (int64) of the cells with log-odds below 0."""
    flat = log_odds.reshape(-1)
    return torch.arange(flat.numel(), device=flat.device)[flat < 0.0]


def sample(free: torch.Tensor, spec, u: torch.Tensor) -> torch.Tensor:
    """Poses ``[S, 3]`` from uniforms ``u [S, 4]``: the cell
    ``free[floor(u0 · n)]``, x and y inside it, the heading from ``u3``."""
    n = free.shape[0]
    k = torch.clamp(torch.floor(u[:, 0] * n).to(torch.int64), max=n - 1)
    cell = free[k]
    row = torch.div(cell, spec.width, rounding_mode="floor")
    col = cell - row * spec.width
    span = 1.0 - 2.0 * MARGIN
    x = spec.origin_x + (col.to(u.dtype) + (MARGIN + u[:, 1] * span)) * spec.resolution
    y = spec.origin_y + (row.to(u.dtype) + (MARGIN + u[:, 2] * span)) * spec.resolution
    th = -math.pi + u[:, 3] * (2.0 * math.pi)
    return torch.stack([x, y, th], dim=-1)


def relocalize(poses, grid, model, ranges, valid, n_keep: int, nudge: bool = True,
               iters: int = 10, max_corr: float = 0.6):
    """The samples ``poses [S, 3]`` scored from equal weights, and the best
    ``n_keep`` of them normalized: ``(scored, kept)``."""
    equal = pf._normalize(torch.zeros(poses.shape[0], dtype=poses.dtype, device=poses.device))
    scored = update(pf.ParticleState(poses, equal), grid, model, ranges, valid, nudge,
                    iters, max_corr)
    order = torch.sort(scored.log_w, descending=True, stable=True).indices[:n_keep]
    vals = scored.log_w[order]
    kept = pf.ParticleState(scored.poses[order], pf._normalize(vals))
    return scored, kept


def estimate_at(scored, idx: torch.Tensor) -> np.ndarray:
    """The estimate (``pf.estimate``, float32 on the host) of the scored
    samples ``idx`` alone: what a kept cloud whose top 8 are those
    samples gives."""
    sel = pf.ParticleState(scored.poses[idx], scored.log_w[idx])
    return pf.estimate(sel).float().cpu().numpy()


def lap(log, split: int, loc: dict, u: torch.Tensor, check_ticks: int, device,
        dtype=torch.float32, visit=None) -> tuple[np.ndarray, np.ndarray, int]:
    """The first ``check_ticks`` ticks of a lap over the second half, each
    relocalized from its uniforms ``u[k] [S, 4]``, with the configuration's
    localization block ``loc``: the estimate of every tick ``[L, 3]``, the
    map's log-odds and the number of free cells. ``visit(k, samples,
    scored, kept)``, where given, sees each tick's samples, their scored
    cloud and the kept cloud."""
    model, scans, _, grid = setup(log, split, float(loc["resolution"]), device, dtype)
    free = free_cells(grid.log_odds)
    ests = []
    for k, t in enumerate(range(split + 1, min(split + 1 + check_ticks, log.ranges.shape[0]))):
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        samples = sample(free, grid.spec, u[k].to(dtype))
        scored, kept = relocalize(samples, grid, model, scans.ranges[t], valid,
                                  int(loc["particles"]), bool(loc["nudge"]),
                                  int(loc["icp_iters"]), float(loc["icp_max_corr"]))
        if visit is not None:
            visit(k, samples, scored, kept)
        ests.append(pf.estimate(kept))
    return (torch.stack(ests).float().cpu().numpy(), grid.log_odds.float().cpu().numpy(),
            int(free.numel()))
