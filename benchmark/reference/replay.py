"""Reference of the offline replay: preprocess, then keyframe odometry with
the plain PSM chain and the ±π correlative re-match, from the raw ranges.

The plain chain costs ~40 ms a step on the card (a few hundred small
launches), ~100 s for a 2672-scan log, so pass 1 runs as lanes side by
side (``ops.odometry.chain_lanes``), from the scans alone: lane ``k``
owns the ``LANE_STEPS`` steps after step ``k·LANE_STEPS`` and starts
``OVERLAP`` steps before them, as the chain starts at the log's first
scan, so that its keyframe has settled on the whole chain's by the first
step it owns. Nothing of the program's output enters."""

from __future__ import annotations

import numpy as np
import torch

from .slam.core.scan import PRESETS
from .slam.ops.odometry import odometry_keyframe
from .slam.ops.preprocess import preprocess

FLAGS = ("switched", "discarded", "weak", "fracture", "rematched")
LANE_STEPS = 40
OVERLAP = 20


def laser_model(log):
    """The sensor preset of a generated log, its start bearing and range
    taken from the log as the CARMEN reader takes them from a header."""
    preset = next(m for m in PRESETS.values() if m.n_beams == log.n_beams)
    return preset.with_start(log.start_rad, log.max_range)


def replay(log, device, dtype=torch.float32, deep_chunk: int = 128,
           lanes: tuple[int, int] | None = (LANE_STEPS, OVERLAP)) -> dict:
    """Everything the program's replay returns, and pass 1's solver
    iterations, computed in ``dtype`` on ``device``; pass 1 in lanes of
    ``lanes = (steps, overlap)``, or as one chain where ``lanes`` is
    None."""
    model = laser_model(log)
    scans = preprocess(torch.as_tensor(log.ranges, device=device).to(dtype), model)
    res, iters = odometry_keyframe(model, scans, deep_chunk=deep_chunk,
                                   timestamps=log.timestamps, lanes=lanes)
    return {
        "poses": res.poses.float().cpu().numpy(),
        "flags": torch.stack([getattr(res, f) for f in FLAGS], 1).cpu().numpy(),
        "ranges": scans.ranges.float().cpu().numpy(),
        "bad": scans.bad.cpu().numpy(),
        "seg": scans.seg.cpu().numpy(),
        "iterations": int(iters.sum()),
        "matches": int(np.prod(iters.shape)),
    }
