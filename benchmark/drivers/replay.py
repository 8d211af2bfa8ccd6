"""Offline odometry replay: whole-log replays back to back in a closed loop,
one at a time. A replay uploads the ranges, runs ``ops.preprocess`` and
``ops.odometry.odometry_keyframe`` and fetches the poses and flags. The
mix's ``paths`` (the generator's trajectory seeds) are the same for every
seed; the seed draws each path's range noise and the order in which the
replays cycle through them."""

from __future__ import annotations

import time

import numpy as np
import torch

from laser_slam_tpu_torch.core.scan import PRESETS
from laser_slam_tpu_torch.ops.odometry import odometry_keyframe
from laser_slam_tpu_torch.ops.preprocess import preprocess

from .. import harness, traffic
from ..reference import replay as ref_replay


def program_model(log):
    preset = next(m for m in PRESETS.values() if m.n_beams == log.n_beams)
    return preset.with_start(log.start_rad, log.max_range)


def compare(outs: list, last_scans, ref: dict, limits: dict) -> list:
    """The checks of a window's replays against the reference: the
    preprocessed scans beam by beam, then for every replay the per-step
    relative poses, the flags and the poses themselves."""
    pre = int(np.sum(last_scans[0] != ref["ranges"]) + np.sum(last_scans[1] != ref["bad"])
              + np.sum(last_scans[2] != ref["seg"]))
    rel_ref = harness.np_relative(ref["poses"][:-1], ref["poses"][1:])
    step_t = step_r = pose_t = 0.0
    flag_diff = 0
    for out in outs:
        poses, flags = out[:, :3], out[:, 3:] > 0.5
        dt, dr = harness.pose_gaps(harness.np_relative(poses[:-1], poses[1:]), rel_ref)
        step_t, step_r = max(step_t, float(dt.max())), max(step_r, float(dr.max()))
        pose_t = max(pose_t, float(harness.pose_gaps(poses, ref["poses"])[0].max()))
        flag_diff = max(flag_diff, int(np.any(flags != ref["flags"], axis=1).sum()))
    values = {"preprocess_diff": pre, "step_gap_m": step_t, "step_gap_rad": step_r,
              "flag_diff": flag_diff, "pose_gap_m": pose_t}
    return [harness.Check(k, float(v), float(limits[k])) for k, v in values.items()]


def logs(cell: harness.Cell) -> list:
    """The mix's paths, each with range noise of its own drawn from the
    seed, in the order the seed draws: ``[(path, log)]``."""
    paths = list(cell.mix["paths"])
    order = np.random.default_rng(cell.seed).permutation(len(paths))
    return [(paths[i], traffic.make_log(cell.cfg, cell.seed * len(paths) + int(i), cell.n_scans,
                                        trajectory_seed=paths[i]))
            for i in order]


def run(cell: harness.Cell) -> harness.Outcome:
    dev = torch.device(cell.device)
    cycle = logs(cell)
    model = program_model(cycle[0][1])
    spans = harness.Spans(cell.trace, cell.device)
    chunk = int(cell.mix["deep_chunk"])

    def replay(log):
        with spans("preprocess", sync=cell.trace):
            scans = preprocess(torch.from_numpy(log.ranges).to(dev), model)
        with spans("odometry"):
            res = odometry_keyframe(model, scans, deep_chunk=chunk,
                                    timestamps=log.timestamps, chain=cell.mix["chain"])
            flags = torch.stack([getattr(res, f) for f in ref_replay.FLAGS], 1)
            out = torch.cat([res.poses, flags.to(res.poses.dtype)], 1).cpu().numpy()
        return out, scans

    for _ in range(int(cell.mix["warmup_laps"])):
        for _, log in cycle:
            replay(log)
    spans.seconds.clear()
    if cell.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    outs, traced = [], []          # (index into cycle, output) of each replay
    last_scans = {}
    with harness.profiled(cell.trace, cell.device, traced):
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_start
        while True:
            k = len(outs) % len(cycle)
            with spans("replay"):
                out, last_scans[k] = replay(cycle[k][1])
            outs.append((k, out))
            if time.perf_counter() - t0 >= cell.seconds:
                break
        window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cell.device != "cpu" else 0
    scans_done = sum(cycle[k][1].ranges.shape[0] for k, _ in outs)
    failed = sum(int(not np.all(np.isfinite(o[:, :3]))) for _, o in outs)
    last_scans = {k: (s.ranges.cpu().numpy(), s.bad.cpu().numpy(), s.seg.cpu().numpy())
                  for k, s in last_scans.items()}

    checks, iters, matches, rematched = [], 0, 0, {}
    for k, (path, log) in enumerate(cycle):
        mine = [o for j, o in outs if j == k]
        if not mine:
            continue
        ref = ref_replay.replay(log, dev, deep_chunk=chunk)
        checks.append(compare(mine, last_scans[k], ref, cell.limits))
        iters += ref["iterations"] * len(mine)
        matches += ref["matches"] * len(mine)
        rematched[path] = int(ref["flags"][:, 4].sum())
    checks = [harness.Check(c[0].name, max(x.value for x in c), c[0].limit)
              for c in zip(*checks)]
    return harness.Outcome(
        attempted=len(outs), failed=failed,
        end_to_end={"odometry_scans_per_s": scans_done / window, "setup_s": setup_s},
        checks=checks, memory_peak_bytes=int(peak), spans=spans.seconds,
        counters={"replays": len(outs), "scans": scans_done, "n_beams": model.n_beams,
                  "window": model.window, "ref_iterations": iters, "ref_matches": matches},
        trace=traced[0] if traced else None,
        notes=[f"{len(outs)} replays, {scans_done} scans in {window:.3f} s",
               f"paths in replay order {[p for p, _ in cycle]}; re-matched steps of each path "
               f"(reference) {rematched}"])


def control(cell: harness.Cell) -> list:
    """The cell's checks with the reference in bfloat16 in the program's
    place, over the mix's paths, the worst of each number."""
    dev = torch.device(cell.device)
    chunk = int(cell.mix["deep_chunk"])
    checks = []
    for _, log in logs(cell):
        want, low = (ref_replay.replay(log, dev, dtype, deep_chunk=chunk)
                     for dtype in (torch.float32, torch.bfloat16))
        out = np.concatenate([low["poses"], low["flags"].astype(np.float32)], 1)
        checks.append(compare([out], (low["ranges"], low["bad"], low["seg"]), want,
                              cell.limits))
    return [harness.Check(c[0].name, max(x.value for x in c), c[0].limit) for c in zip(*checks)]
