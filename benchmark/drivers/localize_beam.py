"""Particle-filter localization with the ray-cast beam model, as ``cli
localize --model beam`` runs it: the occupancy map built in set-up from
the log's first half at ground truth, at the configuration's
resolution, then ticks back to back, in a closed loop, over the second
half; when that half ends the filter restarts from its ground-truth
start. A tick hands over the scan and the odometry increment and ends
when the tick's estimate reaches the host: predict, ``update_beam``
(the dense ray march in chunks of particles), resample if needed,
estimate. No likelihood field is built. The draws come from the seed on
the card as in the ``localize`` driver, and the tick runs the filter's
deterministic halves, so that the reference sees the same draws; the
reference runs the first ``check_ticks`` ticks of a lap."""

from __future__ import annotations

import time

import numpy as np
import torch

from laser_slam_tpu_torch.core import se2
from laser_slam_tpu_torch.localization import particle_filter as pf
from laser_slam_tpu_torch.mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
from laser_slam_tpu_torch.ops.preprocess import preprocess
from laser_slam_tpu_torch.utils.profiling import profiler

from .. import harness, roofline_raycast, traffic
from ..reference import localize_beam as ref
from .localize import make_draws
from .replay import program_model

COUNTERS = ("pf.raycast_rays", "pf.raycast_chunks")


def run(cell: harness.Cell) -> harness.Outcome:
    dev = torch.device(cell.device)
    loc, mix = cell.cfg["localization"], cell.mix
    log = traffic.make_log(cell.cfg, cell.seed, cell.n_scans)
    model = program_model(log)
    n_scans = log.ranges.shape[0]
    split = n_scans // 2
    ticks_per_lap = n_scans - split - 1
    particles, res = int(loc["particles"]), float(loc["resolution"])
    sigma = (float(loc["predict_sigma_xy"]), float(loc["predict_sigma_theta"]))
    beam_sigma = float(loc["beam_sigma"])
    check = int(mix["check_ticks"])
    draws = make_draws(cell.seed, int(mix["draw_sets"]), ticks_per_lap, particles, dev)
    need = roofline_raycast.samples_per_scan(log.ranges, log.min_range, log.max_range, res)

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
        state = pf.update_beam(state, grid, model, scans.ranges[t], valid, sigma=beam_sigma)
        state = pf.maybe_resample_at(state, draws[d]["u"][k])
        return state, pf.estimate(state).cpu().numpy()

    state = start(0)
    for k in range(min(int(mix["warmup_ticks"]), ticks_per_lap)):
        state, _ = tick(state, split + 1 + k, k, 0)
    if cell.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    counted = profiler.counts()
    laps, seconds, traced, samples = [], [], [], 0
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
                samples += int(need[split + 1 + k])
                if time.perf_counter() - t0 >= cell.seconds:
                    done = True
                    break
        window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cell.device != "cpu" else 0
    after = profiler.counts()
    program = {n: after[n] - counted.get(n, 0) for n in COUNTERS if n in after}
    prog_grid = grid.log_odds.cpu().numpy()
    del state, scans, grid

    est_t = est_r = map_gap = 0.0
    for d in sorted({d for d, _ in laps}):
        want, ref_grid = ref.lap(log, split, loc, draws[d], check, dev)
        map_gap = max(map_gap, float(np.abs(prog_grid - ref_grid).max()))
        for dd, ests in laps:
            if dd == d and ests:
                n = min(len(ests), len(want))
                gt_, gr = harness.pose_gaps(np.stack(ests[:n]), want[:n])
                est_t, est_r = max(est_t, float(gt_.max())), max(est_r, float(gr.max()))
    values = {"map_gap": map_gap, "est_gap_m": est_t, "est_gap_rad": est_r}
    checks = [harness.Check(k, v, float(cell.limits[k])) for k, v in values.items()]
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
                  "particle_samples": particles * samples, "grid_cells": spec.width * spec.height,
                  "n_beams": model.n_beams, **program},
        trace=traced[0] if traced else None,
        notes=[f"{n_ticks} ticks in {len(laps)} laps of {ticks_per_lap} in {window:.3f} s; "
               f"tick p50 {1e3 * harness.percentile(seconds, 50):.4f} ms, p95 "
               f"{1e3 * harness.percentile(seconds, 95):.4f} ms; position error against "
               f"ground truth mean {errs.mean():.4f} m, p90 {np.percentile(errs, 90):.4f} m",
               f"grid {spec.width} x {spec.height} at {res} m, {particles} particles x "
               f"{model.n_beams} beams x {roofline_raycast.ladder(model.max_range, res)} "
               f"samples; least samples {samples / max(n_ticks, 1):.1f} a tick a particle; "
               f"program counters a tick: "
               + (", ".join(f"{k} {v / n_ticks:.2f}" for k, v in program.items())
                  if program and n_ticks else "none")])


def control(cell: harness.Cell) -> list:
    """The checks of ``check_ticks`` ticks with the reference in bfloat16
    in the program's place."""
    dev = torch.device(cell.device)
    loc, mix = cell.cfg["localization"], cell.mix
    log = traffic.make_log(cell.cfg, cell.seed, cell.n_scans)
    split = log.ranges.shape[0] // 2
    draws = make_draws(cell.seed, 1, log.ranges.shape[0] - split - 1, int(loc["particles"]), dev)
    check = int(mix["check_ticks"])
    want = ref.lap(log, split, loc, draws[0], check, dev)
    low = ref.lap(log, split, loc, draws[0], check, dev, torch.bfloat16)
    dt, dr = harness.pose_gaps(low[0], want[0])
    values = {"map_gap": float(np.abs(low[1] - want[1]).max()),
              "est_gap_m": float(dt.max()), "est_gap_rad": float(dr.max())}
    return [harness.Check(k, v, float(cell.limits[k])) for k, v in values.items()]
