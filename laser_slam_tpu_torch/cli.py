"""Command-line interface of the PyTorch port.

Usage: ``python -m laser_slam_tpu_torch.cli <command> [options]``

- ``odometry``: read a CARMEN log → preprocess → keyframe (or pairwise)
  odometry → ATE/RPE against the log's ground truth, optionally write
  the trajectory (``--out``) and an occupancy-map PNG (``--map``).
- ``slam``: read a CARMEN log → keyframe odometry → submaps → loop-
  closure waves (propose, verify, robust pose-graph solve) → ATE of the
  odometry and of the optimized trajectory, optionally write the
  trajectory (``--out``) and an occupancy-map PNG (``--map``).
- ``draw``: render an occupancy-map PNG from a log and a trajectory.
- ``localize``: build a map from the first half of a log (at its ground
  truth) and track the second half with the particle filter: position
  error against the ground truth. ``--model`` picks the observation
  model: ``field`` (likelihood field, the default), ``beam`` (the
  ray-cast beam model) or ``icp`` (each particle's scan ray-cast from
  the map and the real scan aligned onto it by point ICP). ``--global``
  starts from a global relocalization on the first tracked scan (10,000
  samples over the map's free space, the best ``--particles`` kept;
  scored by ray-cast + ICP with ``--model icp``, else on the likelihood
  field) instead of a cloud around the ground truth.
- ``eval``: ATE / RPE of a trajectory file against a log's ground truth,
  as one JSON line.
- ``view``: replay a log along a trajectory (``--traj``, default its
  ground truth) in the live viewer; headless unless ``--interactive``,
  ``--out`` writes an animated GIF, ``--frame`` the last frame's PNG.
  It runs on the host (numpy and matplotlib).
- ``serve``: the distributed SLAM server: accept one frontend stream over
  TCP, run the incremental loop-closure backend, push pose corrections
  back; ``--out`` writes the trajectory, ``--diag`` an ``.npz`` with the
  loop bank and the round walls.
- ``client``: the distributed SLAM frontend: odometry over a log, each
  scan streamed to the server, its corrections applied; ``--out`` writes
  the trajectory.

``--device`` picks where the tensors live: ``cuda`` by default, and the
command fails when there is no CUDA device; ``--device cpu`` asks for the
CPU. ``view`` takes the option and holds no tensor.
"""

from __future__ import annotations

import argparse
import json
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


class SlamRun(NamedTuple):
    """What ``slam`` computed, for callers of :func:`main`."""

    log: object          # io.carmen.CarmenLog
    result: object       # runtime.slam.SlamResult
    seconds: float       # slam_offline wall time (incl. kernel build)
    ate_odo: object | None   # eval.metrics.AteResult of the odometry
    ate: object | None       # ... of the optimized trajectory
    diag: dict           # loop bank, anchor poses, stage seconds
    grid: object | None  # mapping.occupancy.OccupancyGrid


def _load(path, max_scans):
    from .io.carmen import read_carmen

    return read_carmen(path, max_scans=max_scans)


def _device(name: str | None) -> torch.device:
    dev = torch.device("cuda" if name is None else name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass --device cpu to run on the CPU")
    return dev


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


def cmd_slam(args) -> SlamRun:
    from .eval.metrics import ate
    from .ops.preprocess import preprocess
    from .runtime.slam import SlamConfig, slam_offline

    dev = _device(args.device)
    log = _load(args.log, args.scans)
    cfg = SlamConfig(
        anchor_stride=args.stride, rounds=args.rounds,
        loop_radius=args.radius, max_loops=args.max_loops,
    )
    diag: dict = {}
    t0 = time.time()
    res = slam_offline(log.model, log.ranges, cfg, diag=diag,
                       timestamps=log.timestamps, device=dev)
    _sync(dev)
    dt = time.time() - t0
    print(
        f"{log.n_scans} scans in {dt:.1f}s; "
        f"loops={int(res.n_loops)} chi2={float(res.chi2):.2f}"
    )
    a_odo = a = None
    if log.gt_pose.size:
        gt = torch.as_tensor(log.gt_pose[: res.poses.shape[0]], device=dev)
        a_odo, a = ate(res.odo_poses, gt), ate(res.poses, gt)
        print(f"ATE odometry rmse={float(a_odo.rmse):.3f}m")
        print(f"ATE slam     rmse={float(a.rmse):.3f}m")
    if args.out:
        np.savetxt(args.out, res.poses.cpu().numpy(), fmt="%.6f")
        print(f"trajectory -> {args.out}")
    grid = None
    if args.map:
        scans = preprocess(torch.as_tensor(log.ranges, device=dev), log.model)
        grid = _render(log, scans, res.poses, args.map, args.resolution)
    return SlamRun(log, res, dt, a_odo, a, diag, grid)


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


class LocalizeRun(NamedTuple):
    """What ``localize`` computed, for callers of :func:`main`."""

    errors: np.ndarray   # [steps] position error against the ground truth, m
    state: object        # localization.particle_filter.ParticleState, the last
    grid: object         # mapping.occupancy.OccupancyGrid of the first half
    seconds: float       # wall time of the tracked steps


def cmd_localize(args) -> LocalizeRun:
    from .core import se2
    from .localization import particle_filter as pf
    from .localization.raycast import likelihood_field
    from .mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
    from .ops.preprocess import preprocess

    dev = _device(args.device)
    log = _load(args.log, args.scans)
    model = log.model
    scans = preprocess(torch.as_tensor(log.ranges, device=dev), model)
    gt = torch.as_tensor(log.gt_pose[: log.n_scans], dtype=torch.float32, device=dev)

    # Build the map from the first part of the log, localize the rest.
    split = log.n_scans // 2
    spec = spec_for_trajectory(log.gt_pose[: log.n_scans], model.max_range, args.resolution)
    grid = integrate_scans(
        empty_grid(spec, device=dev), model, type(scans)(*(x[:split] for x in scans)), gt[:split])
    # The field weighs with ``--model field``; with ``--global`` it also
    # relocalizes, unless ``--model icp`` relocalizes by ray-cast + ICP.
    with_field = args.model == "field" or (args.global_ and args.model == "beam")
    field = likelihood_field(grid) if with_field else None
    free = pf.free_cells(grid) if args.global_ else None

    generator = torch.Generator(device=dev)
    generator.manual_seed(0)
    state = None if args.global_ else pf.init_gaussian(generator, gt[split], args.particles)

    # A tick is predict + weight + resample + estimate, all on the device;
    # the estimates are read back once, after the last tick. With
    # ``--global`` the first tick relocalizes instead of predicting.
    ests = []
    t0 = time.time()
    ticks = range(split + 1, min(split + 1 + args.steps, log.n_scans))
    for t in ticks:
        rel = se2.relative(gt[t - 1], gt[t])  # odometry stand-in
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        if state is None:
            state = pf.relocalize_and_weigh(generator, args.model, grid, field, model,
                                            scans.ranges[t], valid, args.particles, free)
        else:
            state = pf.predict(state, rel, generator, sigma_xy=0.05, sigma_theta=0.03)
            state = pf.weigh(args.model, state, grid, field, model, scans.ranges[t], valid)
        state = pf.maybe_resample(state, generator)
        ests.append(pf.estimate(state))
    if not ests:
        raise SystemExit("localize: the log's second half has no scan to track")
    est = torch.stack(ests)
    errs = torch.sqrt(torch.sum((est[:, :2] - gt[ticks.start:ticks.stop, :2]) ** 2, dim=-1))
    errs = errs.cpu().numpy()
    dt = time.time() - t0
    print(
        f"tracked {len(errs)} steps with {args.particles} particles: "
        f"pos err mean={errs.mean():.3f}m p90={np.percentile(errs, 90):.3f}m"
    )
    return LocalizeRun(errs, state, grid, dt)


def cmd_eval(args) -> dict:
    from .eval.metrics import ate, rpe

    dev = _device(args.device)
    est = torch.as_tensor(np.loadtxt(args.traj, dtype=np.float32), device=dev)
    log = _load(args.log, None)
    gt = torch.as_tensor(log.gt_pose[: est.shape[0]], dtype=torch.float32, device=dev)
    a = ate(est, gt)
    tr, rot = rpe(est, gt)
    out = {
        "ate_rmse": round(float(a.rmse), 4),
        "ate_mean": round(float(a.mean), 4),
        "rpe_trans_mean": round(float(tr.mean()), 4),
        "rpe_rot_mean_deg": round(float(torch.rad2deg(rot.mean())), 4),
    }
    print(json.dumps(out))
    return out


def cmd_view(args):
    """Replay a log in the live viewer; headless by default, writes a GIF
    with ``--out`` and the last frame with ``--frame``. Returns the
    (closed) viewer."""
    from .viz.live import replay_log

    log = _load(args.log, args.scans)
    if args.traj:
        # Clamp to the loaded scan count: a full-log trajectory replayed
        # with --scans K would otherwise index past log.ranges.
        poses = np.loadtxt(args.traj, dtype=np.float32)[: log.n_scans]
    elif log.gt_pose.size:
        poses = log.gt_pose[: log.n_scans]
    else:
        raise SystemExit("no --traj and the log has no ground truth")
    gt = log.gt_pose[: log.n_scans] if (args.traj and log.gt_pose.size) else None
    v = replay_log(log, poses, out=args.out, stride=args.stride, gt=gt,
                   interactive=args.interactive)
    if args.out:
        print(f"animation -> {args.out}")
    if args.frame:
        v.save_frame(args.frame)
        print(f"final frame -> {args.frame}")
    if args.interactive:
        input("press enter to close...")
    v.close()
    return v


class ServeRun(NamedTuple):
    """What ``serve`` computed, for callers of :func:`main`."""

    backend: object      # runtime.tcp_slam.Backend after the session
    port: int            # the port it listened on
    seconds: float       # from the accepted connection to the last round


def cmd_serve(args) -> ServeRun:
    from .core.scan import PRESETS
    from .native.api import ScanServer
    from .runtime.slam import SlamConfig
    from .runtime.tcp_slam import Backend

    dev = _device(args.device)
    model = PRESETS[args.model]
    server = ScanServer(args.port)
    try:
        print(f"listening on :{server.port} ({model.name}, {dev})", flush=True)
        conn = server.accept(timeout_ms=args.timeout * 1000)
        if conn is None:
            raise SystemExit(f"serve: no client connected within {args.timeout} s")
        t0 = time.time()
        be = Backend(conn, model, SlamConfig(), device=dev)
        anchors = be.run()
        dt = time.time() - t0
        conn.close()
    finally:
        server.close()
    print(f"session done: {be.poses.shape[0]} scans, {anchors.shape[0]} anchors, "
          f"{len(be.round_walls)} rounds, {be.n_loops_total} loops, {dt:.1f}s, "
          f"{conn.bytes_received} bytes in, {conn.bytes_sent} bytes out "
          f"({be.n_updates_sent} pose updates)", flush=True)
    if args.out:
        np.savetxt(args.out, be.poses, fmt="%.6f")
        print(f"trajectory -> {args.out}")
    if args.diag:
        bank = be.bank or {}
        np.savez(args.diag, poses=be.poses, round_walls=np.asarray(be.round_walls),
                 n_loops=be.n_loops_total, seconds=dt, bytes_in=conn.bytes_received,
                 n_updates=be.n_updates_sent,
                 bytes_out=conn.bytes_sent, **{f"bank_{k}": v for k, v in bank.items()})
        print(f"diagnostics -> {args.diag}")
    return ServeRun(be, server.port, dt)


class ClientRun(NamedTuple):
    """What ``client`` computed, for callers of :func:`main`."""

    log: object          # io.carmen.CarmenLog
    frontend: object     # runtime.tcp_slam.Frontend after the stream
    seconds: np.ndarray  # [T] wall of each feed_scan
    wall: float          # the whole stream


def cmd_client(args) -> ClientRun:
    from .native.api import ScanSocket
    from .runtime.tcp_slam import Frontend

    dev = _device(args.device)
    log = _load(args.log, args.scans)
    fe = Frontend(ScanSocket.connect(args.host, args.port), log.model, device=dev)
    sec = np.zeros(log.n_scans)
    t0 = time.time()
    for k, r in enumerate(log.ranges):
        t1 = time.perf_counter()
        fe.feed_scan(r, stamp=float(log.timestamps[k]))
        sec[k] = time.perf_counter() - t1
    wall = time.time() - t0
    fe.close()
    print(f"{log.n_scans} scans streamed in {wall:.1f}s ({log.n_scans / wall:.1f} scans/s); "
          f"per scan p50 {np.percentile(sec, 50) * 1e3:.2f} ms p99 "
          f"{np.percentile(sec, 99) * 1e3:.2f} ms; {fe.sock.bytes_sent} bytes sent; "
          f"{fe.n_updates} pose updates applied")
    if args.out:
        np.savetxt(args.out, np.stack(fe.poses), fmt="%.6f")
        print(f"trajectory -> {args.out}")
    return ClientRun(log, fe, sec, wall)


def main(argv=None):
    p = argparse.ArgumentParser(prog="laser_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("log")
        sp.add_argument("--scans", type=int, default=None)
        sp.add_argument("--device", default=None,
                        help="torch device (default: cuda; fails without a CUDA "
                             "device unless cpu is asked for)")

    sp = sub.add_parser("odometry", help="scan-matching odometry over a log")
    common(sp)
    sp.add_argument("--pairwise", action="store_true")
    sp.add_argument("--out")
    sp.add_argument("--map", help="write an occupancy-map PNG here")
    sp.add_argument("--resolution", type=float, default=0.05)
    sp.set_defaults(fn=cmd_odometry)

    from .runtime.slam import SlamConfig

    dflt = SlamConfig()
    sp = sub.add_parser("slam", help="full SLAM with loop closure")
    common(sp)
    sp.add_argument("--stride", type=int, default=dflt.anchor_stride)
    sp.add_argument("--rounds", type=int, default=dflt.rounds)
    sp.add_argument("--radius", type=float, default=dflt.loop_radius)
    sp.add_argument("--max-loops", type=int, default=dflt.max_loops)
    sp.add_argument("--out")
    sp.add_argument("--map", help="write an occupancy-map PNG here")
    sp.add_argument("--resolution", type=float, default=0.05)
    sp.set_defaults(fn=cmd_slam)

    sp = sub.add_parser("draw", help="render occupancy map PNG from a log")
    common(sp)
    sp.add_argument("--traj", help="trajectory file (default: GT poses)")
    sp.add_argument("--out", default="map.png")
    sp.add_argument("--resolution", type=float, default=0.05)
    sp.set_defaults(fn=cmd_draw)

    sp = sub.add_parser("localize", help="particle-filter localization demo")
    common(sp)
    sp.add_argument("--particles", type=int, default=2048)
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--resolution", type=float, default=0.05)
    sp.add_argument("--model", choices=("field", "beam", "icp"), default="field",
                    help="observation model: likelihood field, ray-cast beam model, or "
                         "ray-cast + ICP")
    sp.add_argument("--global", dest="global_", action="store_true",
                    help="start from a global relocalization on the first tracked scan "
                         "instead of a cloud around the ground truth")
    sp.set_defaults(fn=cmd_localize)

    sp = sub.add_parser("view", help="live viewer replay of a log (GIF/window)")
    common(sp)
    sp.add_argument("--traj", help="trajectory file (default: GT poses)")
    sp.add_argument("--out", help="write an animated GIF here")
    sp.add_argument("--frame", help="write the final frame PNG here")
    sp.add_argument("--stride", type=int, default=25)
    sp.add_argument("--interactive", action="store_true")
    sp.set_defaults(fn=cmd_view)

    sp = sub.add_parser("eval", help="ATE/RPE of a trajectory vs log ground truth")
    sp.add_argument("log")
    sp.add_argument("traj")
    sp.add_argument("--device", default=None,
                    help="torch device (default: cuda; fails without a CUDA "
                         "device unless cpu is asked for)")
    sp.set_defaults(fn=cmd_eval)

    device_help = "torch device (default: cuda; fails without a CUDA device unless cpu is asked for)"
    sp = sub.add_parser("serve", help="distributed SLAM backend server")
    sp.add_argument("--port", type=int, default=6188, help="0: a free port, printed")
    sp.add_argument("--model", default="LMS211")
    sp.add_argument("--timeout", type=int, default=300, help="seconds to wait for a client")
    sp.add_argument("--out", help="write the trajectory here")
    sp.add_argument("--diag", help="write the loop bank and round walls (.npz) here")
    sp.add_argument("--device", default=None, help=device_help)
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("client", help="distributed SLAM frontend client")
    common(sp)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=6188)
    sp.add_argument("--out", help="write the trajectory here")
    sp.set_defaults(fn=cmd_client)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
