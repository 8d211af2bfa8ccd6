"""One tick of the beam-model localization cell's shape, for the ray-march
kernel's card tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py``.

- :func:`beam_cell` makes the map, the cloud and the scan of one tick:
  a 2 cm map of :mod:`synthetic_log`'s floor plan, 4096 poses of cm
  spread, 361 beams of 50 m.
- :func:`ladder_in_chunks` gives their plain ranges, the dense ladder in
  the chunks of poses that fit its 2 GiB.

Import it with this directory on ``sys.path``, as :mod:`synthetic_log`.
"""

from __future__ import annotations

import numpy as np
import torch

import synthetic_log as synth
from laser_slam_tpu_torch.core.scan import PRESETS, Scan
from laser_slam_tpu_torch.localization import raycast
from laser_slam_tpu_torch.mapping import occupancy
from laser_slam_tpu_torch.ops import preprocess


def beam_cell(n_particles: int = 4096, seed: int = 0, device="cuda"):
    """One tick of the beam-model cell's shape: the 2 cm map of the first
    half of a 1464-scan log of the synthetic floor plan, seen at 361 beams
    (0.5 degree from -90, 50 m), integrated at ground truth; a cloud of
    ``n_particles`` poses around the ground truth of the second half's
    first scan, spread as ``cli localize``'s predict noise (5 cm, 0.03
    rad); and that scan. Returns ``(grid, model, poses, ranges, valid)``
    on ``device``."""
    model = PRESETS["LMS511"].with_start(-np.pi / 2)
    gt, _ = synth.trajectory(1464, seed=seed)
    r = synth.ray_cast(synth.floor_plan(), gt, model.bearings(torch.float64).numpy())
    rng = np.random.default_rng(seed + 1)
    r = np.where(r <= synth.MAX_RANGE, r + rng.normal(0.0, synth.NOISE, r.shape), r)
    dev = torch.device(device)
    scans = preprocess.preprocess(torch.as_tensor(r.astype(np.float32), device=dev), model)
    poses = torch.as_tensor(gt, dtype=torch.float32, device=dev)
    split = gt.shape[0] // 2
    spec = occupancy.spec_for_trajectory(gt, model.max_range,
                                         occupancy.LOCALIZATION_RESOLUTION)
    grid = occupancy.integrate_scans(occupancy.empty_grid(spec, device=dev), model,
                                     Scan(*(x[:split] for x in scans)), poses[:split])
    t = split + 1
    g = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn(n_particles, 3, generator=g, device=dev)
    cloud = poses[t] + noise * torch.tensor([0.05, 0.05, 0.03], device=dev)
    return grid, model, cloud, scans.ranges[t], ~scans.bad[t] & (scans.ranges[t] < model.max_range)


def ladder_in_chunks(grid, model, poses, chunk: int = 61) -> torch.Tensor:
    """The dense ladder over ``poses [P, 3]`` in chunks of ``chunk``
    poses, as ``update_beam`` sizes them for it (2 GiB at the cell's
    shape)."""
    return torch.cat([raycast._simulate_scan_ladder(grid, model, poses[i:i + chunk])
                      for i in range(0, poses.shape[0], chunk)])
