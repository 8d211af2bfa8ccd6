"""Command-line interface of the PyTorch port.

Usage: ``python -m laser_slam_tpu_torch.cli <command> [options]``

- ``odometry``: read a CARMEN log → preprocess → keyframe (or pairwise)
  odometry → ATE/RPE against the log's ground truth, optionally write
  the trajectory (``--out``) and an occupancy-map PNG (``--map``).
- ``draw``: render an occupancy-map PNG from a log and a trajectory.

``--device`` picks where the tensors live (``cuda`` by default when a
card is present, else ``cpu``).
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch


class OdometryRun(NamedTuple):
    """What ``odometry`` computed, for callers of :func:`main`."""

    log: object          # io.carmen.CarmenLog
    scans: object        # core.scan.Scan [T, N] on the device
    result: object       # ops.odometry.OdometryResult
    seconds: float       # odometry wall time (incl. kernel build)
    ate: object | None   # eval.metrics.AteResult
    rpe: tuple | None    # (translation [T-1], rotation [T-1])
    grid: object | None  # mapping.occupancy.OccupancyGrid


def _load(path, max_scans):
    from .io.carmen import read_carmen

    return read_carmen(path, max_scans=max_scans)


def _device(name: str | None) -> torch.device:
    if name is None:
        name = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(name)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def cmd_odometry(args) -> OdometryRun:
    from .eval.metrics import ate, rpe
    from .ops.odometry import odometry_keyframe, odometry_pairwise
    from .ops.preprocess import preprocess

    dev = _device(args.device)
    log = _load(args.log, args.scans)
    scans = preprocess(torch.as_tensor(log.ranges, device=dev), log.model)
    t0 = time.time()
    if args.pairwise:
        res = odometry_pairwise(log.model, scans)
    else:
        # Timestamps drive frame-drop fracture detection.
        res = odometry_keyframe(log.model, scans, timestamps=log.timestamps)
    _sync(dev)
    dt = time.time() - t0
    est = res.poses.cpu().numpy()
    print(f"{log.n_scans} scans in {dt:.2f}s (incl. compile)")
    a = r = None
    if log.gt_pose.size:
        gt = torch.as_tensor(log.gt_pose[: est.shape[0]], device=dev)
        a = ate(res.poses, gt)
        r = rpe(res.poses, gt)
        print(f"ATE rmse={float(a.rmse):.3f}m mean={float(a.mean):.3f}m")
    if args.out:
        np.savetxt(args.out, est, fmt="%.6f")
        print(f"trajectory -> {args.out}")
    grid = None
    if args.map:
        grid = _render(log, scans, res.poses, args.map, args.resolution)
    return OdometryRun(log, scans, res, dt, a, r, grid)


def _render(log, scans, poses, out, resolution):
    from .mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
    from .viz.render import render_map_png

    poses_np = poses.cpu().numpy()
    spec = spec_for_trajectory(poses_np, log.model.max_range, resolution)
    grid = integrate_scans(
        empty_grid(spec, device=scans.ranges.device), log.model, scans, poses
    )
    render_map_png(grid, out, poses_np)
    print(f"map ({spec.width}x{spec.height} @ {resolution}m) -> {out}")
    return grid


def cmd_draw(args):
    from .ops.preprocess import preprocess

    dev = _device(args.device)
    log = _load(args.log, args.scans)
    poses = (
        np.loadtxt(args.traj, dtype=np.float32)
        if args.traj
        else log.gt_pose[: log.n_scans]
    )
    n = min(log.n_scans, poses.shape[0])
    scans = preprocess(torch.as_tensor(log.ranges[:n], device=dev), log.model)
    return _render(log, scans, torch.as_tensor(poses[:n], device=dev), args.out,
                   args.resolution)


def main(argv=None):
    p = argparse.ArgumentParser(prog="laser_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("log")
        sp.add_argument("--scans", type=int, default=None)
        sp.add_argument("--device", default=None,
                        help="torch device (default: cuda if available, else cpu)")

    sp = sub.add_parser("odometry", help="scan-matching odometry over a log")
    common(sp)
    sp.add_argument("--pairwise", action="store_true")
    sp.add_argument("--out")
    sp.add_argument("--map", help="write an occupancy-map PNG here")
    sp.add_argument("--resolution", type=float, default=0.05)
    sp.set_defaults(fn=cmd_odometry)

    sp = sub.add_parser("draw", help="render occupancy map PNG from a log")
    common(sp)
    sp.add_argument("--traj", help="trajectory file (default: GT poses)")
    sp.add_argument("--out", default="map.png")
    sp.add_argument("--resolution", type=float, default=0.05)
    sp.set_defaults(fn=cmd_draw)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
