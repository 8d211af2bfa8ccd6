"""Particle-filter localization as ``cli localize`` runs it: the map and its
likelihood field built in set-up from the log's first half at ground
truth, then ticks back to back, in a closed loop, over the second half;
when that half ends the filter restarts from its ground-truth start. A
tick hands over the scan and the odometry increment and ends when the
tick's estimate reaches the host: predict, field weights, resample if
needed, estimate. The predict noise and the resample uniforms are drawn
from the seed on the card (``draw_sets`` laps of them, used in turn), and
the tick runs the filter's deterministic halves, so that the reference
sees the same draws."""

from __future__ import annotations

import time

import numpy as np
import torch

from laser_slam_tpu_torch.core import se2
from laser_slam_tpu_torch.localization import particle_filter as pf
from laser_slam_tpu_torch.localization.raycast import likelihood_field
from laser_slam_tpu_torch.mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
from laser_slam_tpu_torch.ops.preprocess import preprocess

from .. import harness, traffic
from ..reference import localize as ref
from .replay import program_model


def make_draws(seed: int, sets: int, ticks: int, particles: int, device) -> list[dict]:
    """Standard-normal predict and initial-cloud draws and resample
    uniforms for ``sets`` laps, in a few large calls on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    xy = torch.randn(sets, ticks, particles, 2, generator=g, device=device)
    t = torch.randn(sets, ticks, particles, generator=g, device=device)
    u = torch.rand(sets, ticks, generator=g, device=device)
    init_xy = torch.randn(sets, particles, 2, generator=g, device=device)
    init_t = torch.randn(sets, particles, generator=g, device=device)
    return [{"xy": xy[d], "t": t[d], "u": u[d], "init_xy": init_xy[d], "init_t": init_t[d]}
            for d in range(sets)]


def run(cell: harness.Cell) -> harness.Outcome:
    dev = torch.device(cell.device)
    mix = cell.mix
    log = traffic.make_log(cell.cfg, cell.seed, cell.n_scans)
    model = program_model(log)
    n_scans = log.ranges.shape[0]
    split = n_scans // 2
    ticks_per_lap = n_scans - split - 1
    sigma = (float(mix["sigma_xy"]), float(mix["sigma_theta"]))
    draws = make_draws(cell.seed, int(mix["draw_sets"]), ticks_per_lap, int(mix["particles"]), dev)

    scans = preprocess(torch.from_numpy(log.ranges).to(dev), model)
    gt = torch.from_numpy(log.gt).to(dev)
    spec = spec_for_trajectory(log.gt, model.max_range, float(mix["resolution"]))
    grid = integrate_scans(empty_grid(spec, device=dev), model,
                           type(scans)(*(x[:split] for x in scans)), gt[:split])
    field = likelihood_field(grid)

    def start(d):
        return pf.init_from_noise(gt[split], draws[d]["init_xy"], draws[d]["init_t"])

    def tick(state, t, k, d):
        rel = se2.relative(gt[t - 1], gt[t])
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        state = pf.predict_with_noise(state, rel, draws[d]["xy"][k], draws[d]["t"][k], *sigma)
        state = pf.update_field(state, field, grid, model, scans.ranges[t], valid)
        state = pf.maybe_resample_at(state, draws[d]["u"][k])
        return state, pf.estimate(state).cpu().numpy()

    state = start(0)
    for k in range(min(int(mix["warmup_ticks"]), ticks_per_lap)):
        state, _ = tick(state, split + 1 + k, k, 0)
    if cell.device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    laps, seconds, traced = [], [], []
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
                if time.perf_counter() - t0 >= cell.seconds:
                    done = True
                    break
        window = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cell.device != "cpu" else 0
    prog_grid, prog_field = grid.log_odds.cpu().numpy(), field.cpu().numpy()
    del state, scans, grid, field

    est_t = est_r = 0.0
    map_gap = field_gap = 0.0
    for d in sorted({d for d, _ in laps}):
        want, ref_grid, ref_field = ref.lap(log, split, float(mix["resolution"]), draws[d],
                                            sigma, dev)
        map_gap, field_gap = float(np.abs(prog_grid - ref_grid).max()), float(
            np.abs(prog_field - ref_field).max())
        for dd, ests in laps:
            if dd == d and ests:
                gt_, gr = harness.pose_gaps(np.stack(ests), want[:len(ests)])
                est_t, est_r = max(est_t, float(gt_.max())), max(est_r, float(gr.max()))
    values = {"map_gap": map_gap, "field_gap": field_gap, "est_gap_m": est_t,
              "est_gap_rad": est_r}
    checks = [harness.Check(k, v, float(cell.limits[k])) for k, v in values.items()]
    errs = np.concatenate([np.hypot(*(np.stack(e)[:, :2] - log.gt[split + 1:split + 1 + len(e), :2]).T)
                           for _, e in laps if e])
    return harness.Outcome(
        attempted=len(seconds), failed=int(sum(not np.all(np.isfinite(e)) for _, x in laps
                                               for e in x)),
        end_to_end={"localize_tick_p95_ms": 1e3 * harness.percentile(seconds, 95),
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=int(peak), spans=spans.seconds,
        counters={"ticks": len(seconds), "laps": len(laps)},
        trace=traced[0] if traced else None,
        notes=[f"{len(seconds)} ticks in {len(laps)} laps of {ticks_per_lap} in {window:.3f} s; "
               f"tick p50 {1e3 * harness.percentile(seconds, 50):.4f} ms, p95 "
               f"{1e3 * harness.percentile(seconds, 95):.4f} ms; position error against "
               f"ground truth mean {errs.mean():.4f} m, p90 {np.percentile(errs, 90):.4f} m"])


def control(cell: harness.Cell) -> list:
    """The checks of one lap with the reference in bfloat16 in the
    program's place."""
    dev = torch.device(cell.device)
    mix = cell.mix
    log = traffic.make_log(cell.cfg, cell.seed, cell.n_scans)
    split = log.ranges.shape[0] // 2
    draws = make_draws(cell.seed, 1, log.ranges.shape[0] - split - 1, int(mix["particles"]), dev)
    sigma = (float(mix["sigma_xy"]), float(mix["sigma_theta"]))
    want = ref.lap(log, split, float(mix["resolution"]), draws[0], sigma, dev)
    low = ref.lap(log, split, float(mix["resolution"]), draws[0], sigma, dev, torch.bfloat16)
    dt, dr = harness.pose_gaps(low[0], want[0])
    values = {"map_gap": float(np.abs(low[1] - want[1]).max()),
              "field_gap": float(np.abs(low[2] - want[2]).max()),
              "est_gap_m": float(dt.max()), "est_gap_rad": float(dr.max())}
    return [harness.Check(k, v, float(cell.limits[k])) for k, v in values.items()]
