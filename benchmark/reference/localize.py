"""Reference of particle-filter localization: the occupancy map of the
log's first half at ground truth, its likelihood field, and the ticks of
the second half (predict with the given draws, field weights, resample
when the effective sample size is low, estimate), all from the raw
ranges and the draws the benchmark hands both sides."""

from __future__ import annotations

import numpy as np
import torch

from .replay import laser_model
from .slam.core import se2
from .slam.localization import particle_filter as pf
from .slam.localization.raycast import likelihood_field
from .slam.mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
from .slam.ops.preprocess import preprocess


def setup(log, split: int, resolution: float, device, dtype=torch.float32):
    """``(model, scans, gt, grid, field)`` on ``device``."""
    model = laser_model(log)
    scans = preprocess(torch.as_tensor(log.ranges, device=device).to(dtype), model)
    gt = torch.as_tensor(log.gt, device=device).to(dtype)
    spec = spec_for_trajectory(log.gt, model.max_range, resolution)
    grid = integrate_scans(empty_grid(spec, dtype=dtype, device=device), model,
                           type(scans)(*(x[:split] for x in scans)), gt[:split])
    return model, scans, gt, grid, likelihood_field(grid)


def lap(log, split: int, resolution: float, draws: dict, sigma: tuple, device,
        dtype=torch.float32) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One lap over the second half from the ground-truth pose at
    ``split``: the estimate of every tick ``[L, 3]``, and the map's
    log-odds and field."""
    model, scans, gt, grid, field = setup(log, split, resolution, device, dtype)
    state = pf.init_from_noise(gt[split], draws["init_xy"].to(dtype), draws["init_t"].to(dtype))
    ests = []
    for k, t in enumerate(range(split + 1, log.ranges.shape[0])):
        rel = se2.relative(gt[t - 1], gt[t])
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        state = pf.predict_with_noise(state, rel, draws["xy"][k].to(dtype),
                                      draws["t"][k].to(dtype), *sigma)
        state = pf.update_field(state, field, grid, model, scans.ranges[t], valid)
        state = pf.maybe_resample_at(state, draws["u"][k].to(dtype))
        ests.append(pf.estimate(state))
    return (torch.stack(ests).float().cpu().numpy(), grid.log_odds.float().cpu().numpy(),
            field.float().cpu().numpy())
