"""Particle-filter localization with the ray-cast + ICP model, as ``cli
localize --model icp`` runs it: the occupancy map built in set-up from
the log's first half at ground truth, at the configuration's resolution,
then ticks back to back, in a closed loop, over the second half; when
that half ends the filter restarts from its ground-truth start. A tick
hands over the scan and the odometry increment and ends when the tick's
estimate reaches the host: predict, ``update_raycast_icp`` (the march,
then the point ICP of the real scan onto each particle's simulated scan,
goodness weights and the nudge), resample if needed, estimate. No
likelihood field is built. The draws come from the seed on the card as
in the ``localize`` driver.

``correct`` compares three things with the reference
(``reference/localize_icp.py``), which runs the first ``check_ticks``
ticks of each lap's draws: the map's log-odds; each of those ticks'
update, computed by the program from the reference's own cloud before
the update, against the reference's (the 99th percentile over the
particles of the log-weight and nudged-pose gaps, worst tick: a few
particles may match one point more or less where their chunks round the
float sums apart); and the window's estimates against the reference's.
The update is checked on the reference's cloud, not on a re-run of the
program's lap, because a reference update at the cell's size costs
~0.4 s on the card (its dense ladder) and its lap computes it anyway."""

from __future__ import annotations

import time

import numpy as np
import torch

from laser_slam_tpu_torch.core import se2
from laser_slam_tpu_torch.localization import particle_filter as pf
from laser_slam_tpu_torch.mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
from laser_slam_tpu_torch.ops.preprocess import preprocess
from laser_slam_tpu_torch.utils.profiling import profiler

from .. import harness, roofline_icp, traffic
from ..reference import localize_beam as ref_setup
from ..reference import localize_icp as ref
from .localize import make_draws
from .replay import program_model

COUNTERS = ("pf.icp_pairs", "pf.icp_chunks", "pf.raycast_rays", "pf.raycast_chunks",
            "raycast.march_launches", "pf.graph_replays")


def run(cell: harness.Cell) -> harness.Outcome:
    update = pf.update_raycast_icp       # a program without the model fails here, at once
    dev = torch.device(cell.device)
    loc, mix = cell.cfg["localization"], cell.mix
    log = traffic.make_log(cell.cfg, cell.seed, cell.n_scans)
    model = program_model(log)
    n_scans = log.ranges.shape[0]
    split = n_scans // 2
    ticks_per_lap = n_scans - split - 1
    particles, res = int(loc["particles"]), float(loc["resolution"])
    sigma = (float(loc["predict_sigma_xy"]), float(loc["predict_sigma_theta"]))
    nudge = bool(loc["nudge"])
    draws = make_draws(cell.seed, int(mix["draw_sets"]), ticks_per_lap, particles, dev)
    points = roofline_icp.scan_points(log.ranges, log.min_range, log.max_range)

    scans = preprocess(torch.from_numpy(log.ranges).to(dev), model)
    gt = torch.from_numpy(log.gt).to(dev)
    spec = spec_for_trajectory(log.gt, model.max_range, res)
    grid = integrate_scans(empty_grid(spec, device=dev), model,
                           type(scans)(*(x[:split] for x in scans)), gt[:split])

    def start(d):
        return pf.init_from_noise(gt[split], draws[d]["init_xy"], draws[d]["init_t"])

    def tick(state, t, k, d):
        rel = se2.relative(gt[t - 1], gt[t])
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        state = pf.predict_with_noise(state, rel, draws[d]["xy"][k], draws[d]["t"][k], *sigma)
        state = update(state, grid, model, scans.ranges[t], valid, nudge=nudge)
        state = pf.maybe_resample_at(state, draws[d]["u"][k])
        return state, pf.estimate(state).cpu().numpy()

    state = start(0)
    for k in range(min(int(mix["warmup_ticks"]), ticks_per_lap)):
        state, _ = tick(state, split + 1 + k, k, 0)
    if cell.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    counted = profiler.counts()
    laps, seconds, traced, n_points = [], [], [], 0
    spans = harness.Spans(cell.trace, cell.device)
    with harness.profiled(cell.trace, cell.device, traced):
        t0 = time.perf_counter()
        setup_s = t0 - cell.t_start
        done = False
        while not done:
            d = len(laps) % len(draws)
            state, ests = start(d), []
            laps.append((d, ests))
            for k in range(ticks_per_lap):
                a = time.perf_counter()
                with spans("tick"):
                    state, est = tick(state, split + 1 + k, k, d)
                seconds.append(time.perf_counter() - a)
                ests.append(est)
                n_points += int(points[split + 1 + k])
                if time.perf_counter() - t0 >= cell.seconds:
                    done = True
                    break
        window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cell.device != "cpu" else 0
    after = profiler.counts()
    program = {n: after[n] - counted.get(n, 0) for n in COUNTERS if n in after}
    del state

    def program_update(before, t):
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        return update(pf.ParticleState(before.poses, before.log_w), grid, model,
                      scans.ranges[t], valid, nudge=nudge)

    checks, moved = compare(cell, log, split, draws, laps, grid.log_odds.cpu().numpy(),
                            program_update, dev)
    errs = np.concatenate([np.hypot(*(np.stack(e)[:, :2] - log.gt[split + 1:split + 1 + len(e), :2]).T)
                           for _, e in laps if e])
    n_ticks = len(seconds)
    return harness.Outcome(
        attempted=n_ticks, failed=int(sum(not np.all(np.isfinite(e)) for _, x in laps
                                          for e in x)),
        end_to_end={"localize_tick_p95_ms": 1e3 * harness.percentile(seconds, 95),
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=int(peak), spans=spans.seconds,
        counters={"ticks": n_ticks, "laps": len(laps), "particles": particles,
                  "particle_points": particles * n_points, "n_beams": model.n_beams,
                  "icp_iters": int(loc["icp_iters"]), **program},
        trace=traced[0] if traced else None,
        notes=[f"{n_ticks} ticks in {len(laps)} laps of {ticks_per_lap} in {window:.3f} s; "
               f"tick p50 {1e3 * harness.percentile(seconds, 50):.4f} ms, p95 "
               f"{1e3 * harness.percentile(seconds, 95):.4f} ms; position error against "
               f"ground truth mean {errs.mean():.4f} m, p90 {np.percentile(errs, 90):.4f} m",
               f"grid {spec.width} x {spec.height} at {res} m, {particles} particles x "
               f"{model.n_beams} beams, {int(loc['icp_iters'])} ICP iterations; valid points "
               f"{n_points / max(n_ticks, 1):.1f} a tick; program counters a tick: "
               + (", ".join(f"{k} {v / n_ticks:.2f}" for k, v in program.items())
                  if program and n_ticks else "none"),
               f"checked updates: at most {moved} of {particles} particles a tick with a "
               f"log-weight or a pose more than 1e-4 from the reference's"])


def update_gaps(got, want) -> dict:
    """The 99th percentile over the particles of the log-weight gap and of
    the nudged poses' translation and rotation gaps, and how many
    particles moved more than 1e-4 in any of them."""
    dw = np.abs(got.log_w.double().cpu().numpy() - want.log_w.double().cpu().numpy())
    dt, dr = harness.pose_gaps(got.poses.double().cpu().numpy(), want.poses.double().cpu().numpy())
    return {"upd_logw_p99": float(np.percentile(dw, 99)),
            "upd_pose_p99_m": float(np.percentile(dt, 99)),
            "upd_pose_p99_rad": float(np.percentile(dr, 99)),
            "moved": int(np.sum((dw > 1e-4) | (dt > 1e-4) | (dr > 1e-4)))}


def compare(cell, log, split: int, draws: list, laps: list, prog_grid: np.ndarray,
            program_update, dev) -> tuple[list, int]:
    """The checks of a window's ``laps`` (``(draw set, estimates)``)
    against the reference: the map, each checked tick's update
    ``program_update(cloud, t)`` from the reference's cloud, and the
    window's estimates; and the most particles of a checked tick whose
    log-weight or pose moved more than 1e-4 from the reference's."""
    loc, check = cell.cfg["localization"], int(cell.mix["check_ticks"])
    values = dict.fromkeys(("map_gap", "upd_logw_p99", "upd_pose_p99_m", "upd_pose_p99_rad",
                            "est_gap_m", "est_gap_rad"), 0.0)
    moved = [0]

    def visit(k, before, after, inputs):
        got = program_update(before, split + 1 + k)
        gaps = update_gaps(got, after)
        moved[0] = max(moved[0], gaps.pop("moved"))
        for name, v in gaps.items():
            values[name] = max(values[name], v)

    for d in sorted({d for d, _ in laps}):
        want, ref_grid = ref.lap(log, split, loc, draws[d], check, dev, visit=visit)
        values["map_gap"] = max(values["map_gap"], float(np.abs(prog_grid - ref_grid).max()))
        for dd, ests in laps:
            if dd == d and ests:
                n = min(len(ests), len(want))
                gt_, gr = harness.pose_gaps(np.stack(ests[:n]), want[:n])
                values["est_gap_m"] = max(values["est_gap_m"], float(gt_.max()))
                values["est_gap_rad"] = max(values["est_gap_rad"], float(gr.max()))
    return [harness.Check(k, v, float(cell.limits[k])) for k, v in values.items()], moved[0]


def control(cell: harness.Cell) -> list:
    """The checks of ``check_ticks`` ticks with the reference in bfloat16
    in the program's place: its map, its update from the float32
    reference's cloud, and its own lap's estimates."""
    dev = torch.device(cell.device)
    loc = cell.cfg["localization"]
    log = traffic.make_log(cell.cfg, cell.seed, cell.n_scans)
    split = log.ranges.shape[0] // 2
    low = torch.bfloat16
    draws = make_draws(cell.seed, 1, log.ranges.shape[0] - split - 1, int(loc["particles"]), dev)
    ests, grid = ref.lap(log, split, loc, draws[0], int(cell.mix["check_ticks"]), dev, low)
    model, scans, _, low_grid = ref_setup.setup(log, split, float(loc["resolution"]), dev, low)

    def low_update(before, t):
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        return ref.update(type(before)(before.poses.to(low), before.log_w.to(low)), low_grid,
                          model, scans.ranges[t], valid, bool(loc["nudge"]),
                          int(loc["icp_iters"]), float(loc["icp_max_corr"]))

    return compare(cell, log, split, draws, [(0, list(ests))], grid, low_update, dev)[0]
