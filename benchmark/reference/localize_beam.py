"""Reference of ray-cast beam-model localization: the occupancy map of the
log's first half at ground truth, and the first ``check_ticks`` ticks of
the second half (predict with the given draws, beam-model weights from
the dense ray march, resample when the effective sample size is low,
estimate), all from the raw ranges and the draws the benchmark hands
both sides. TF32 is off: the float32 comparison holds float32 math."""

from __future__ import annotations

import numpy as np
import torch

from .replay import laser_model
from .slam.core import se2
from .slam.localization import particle_filter as pf
from .slam.mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
from .slam.ops.preprocess import preprocess


def setup(log, split: int, resolution: float, device, dtype=torch.float32):
    """``(model, scans, gt, grid)`` on ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = laser_model(log)
    scans = preprocess(torch.as_tensor(log.ranges, device=device).to(dtype), model)
    gt = torch.as_tensor(log.gt, device=device).to(dtype)
    spec = spec_for_trajectory(log.gt, model.max_range, resolution)
    grid = integrate_scans(empty_grid(spec, dtype=dtype, device=device), model,
                           type(scans)(*(x[:split] for x in scans)), gt[:split])
    return model, scans, gt, grid


def lap(log, split: int, loc: dict, draws: dict, check_ticks: int, device,
        dtype=torch.float32) -> tuple[np.ndarray, np.ndarray]:
    """The first ``check_ticks`` ticks of a lap over the second half from
    the ground-truth pose at ``split``, with the configuration's
    localization block ``loc``: the estimate of every tick ``[L, 3]`` and
    the map's log-odds."""
    model, scans, gt, grid = setup(log, split, float(loc["resolution"]), device, dtype)
    sigma = (float(loc["predict_sigma_xy"]), float(loc["predict_sigma_theta"]))
    state = pf.init_from_noise(gt[split], draws["init_xy"].to(dtype), draws["init_t"].to(dtype))
    ests = []
    for k, t in enumerate(range(split + 1, min(split + 1 + check_ticks, log.ranges.shape[0]))):
        rel = se2.relative(gt[t - 1], gt[t])
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        state = pf.predict_with_noise(state, rel, draws["xy"][k].to(dtype),
                                      draws["t"][k].to(dtype), *sigma)
        state = pf.update_beam(state, grid, model, scans.ranges[t], valid,
                               sigma=float(loc["beam_sigma"]))
        state = pf.maybe_resample_at(state, draws["u"][k].to(dtype))
        ests.append(pf.estimate(state))
    return torch.stack(ests).float().cpu().numpy(), grid.log_odds.float().cpu().numpy()
