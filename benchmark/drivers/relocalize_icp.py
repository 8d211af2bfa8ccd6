"""Global relocalization with the ray-cast + ICP model, as ``cli localize
--global --model icp`` runs its first tick and as ``SlamV1``'s
localization mode runs its first scan: the occupancy map built in set-up
from the log's first half at ground truth, at the configuration's
resolution, with the table of its free cells; then ticks back to back, in
a closed loop, over the second half in log order. A tick hands over one
scan and no prior and ends when the top-8 estimate of the relocalized
cloud reaches the host: ``samples`` poses drawn from free space, each
scored by ``update_raycast_icp`` (the march, the point ICP of the real
scan onto the sample's simulated scan, goodness weights and the nudge),
the best ``particles`` kept, the estimate. The uniforms, ``[samples, 4]``
a tick, are drawn from the seed on the card before the window,
``draw_sets`` laps of them used in turn.

``correct`` compares with the reference (``reference/relocalize_icp.py``),
which runs the first ``check_ticks`` ticks of each lap's draws: the map's
log-odds; the number of free cells; each of those ticks' samples, drawn
by the program from the same uniforms; the program's scoring of the
reference's own samples against the reference's (the 99th percentile
over the samples of the log-weight and nudged-pose gaps, worst tick: a
few samples may match one point more or less where the two sides' chunks
round the float sums apart); its kept cloud's log-weights by rank (their
mean gap and their 99th percentile over the ranks: a sample that matched
one point more or less moves a rank by one step of the goodness, up to
~0.05 in log-weight at the 20-point floor); the window's estimate of
every checked tick against the estimate of the reference's scoring at
the samples the program put in its top 8; and a count of the checked
ticks where the program's top-8 samples are not the reference's. In a
floor plan with near-symmetric places a one-point difference in one
sample's match can swap a member of the top 8 and move the estimate by
metres with no fault in either side: the count holds such swaps to a
few, and the estimate's comparison at the program's own top 8 does not
read them as a gap.

The configuration's ICP settings (``icp_iters``, ``icp_max_corr``,
``nudge``) feed the reference; the program runs its own constants, so a
configuration that states other settings is refused at once."""

from __future__ import annotations

import time

import numpy as np
import torch

from laser_slam_tpu_torch.localization import particle_filter as pf
from laser_slam_tpu_torch.mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
from laser_slam_tpu_torch.ops.preprocess import preprocess
from laser_slam_tpu_torch.utils.profiling import profiler

from .. import harness, roofline_icp, traffic
from ..reference import localize_beam as ref_setup
from ..reference import relocalize_icp as ref
from .replay import program_model

COUNTERS = ("pf.reloc_samples", "pf.reloc_kept", "pf.reloc_free_cells", "pf.icp_pairs",
            "pf.icp_chunks", "raycast.march_launches", "icp.nearest_two_launches")
TOP_K = 8
# A relocalized estimate counts as found within this of ground truth.
FOUND_M, FOUND_RAD = 0.5, 0.2


def make_uniforms(seed: int, sets: int, ticks: int, samples: int, device) -> torch.Tensor:
    """Uniforms ``[sets, ticks, samples, 4]`` in one call on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.rand(sets, ticks, samples, 4, generator=g, device=device)


def top_indices(log_w: torch.Tensor) -> torch.Tensor:
    """The indices of the ``TOP_K`` largest log-weights, the lower index
    first among equals."""
    return torch.sort(log_w, descending=True, stable=True).indices[:TOP_K]


def run(cell: harness.Cell) -> harness.Outcome:
    relocalize = pf.global_relocalize_at    # a program without it fails here, at once
    dev = torch.device(cell.device)
    loc, mix = cell.cfg["localization"], cell.mix
    runs = {"icp_iters": pf.PF_ICP_ITERS, "icp_max_corr": pf.PF_ICP_MAX_CORR, "nudge": True}
    if any(loc[k] != v for k, v in runs.items()):
        raise ValueError(f"the configuration states {({k: loc[k] for k in runs})}; "
                         f"the program runs {runs}")
    log = traffic.make_log(cell.cfg, cell.seed, cell.n_scans)
    model = program_model(log)
    n_scans = log.ranges.shape[0]
    split = n_scans // 2
    ticks_per_lap = n_scans - split - 1
    samples, keep, res = int(loc["samples"]), int(loc["particles"]), float(loc["resolution"])
    draws = make_uniforms(cell.seed, int(mix["draw_sets"]), ticks_per_lap, samples, dev)
    points = roofline_icp.scan_points(log.ranges, log.min_range, log.max_range)

    scans = preprocess(torch.from_numpy(log.ranges).to(dev), model)
    gt = torch.from_numpy(log.gt).to(dev)
    spec = spec_for_trajectory(log.gt, model.max_range, res)
    grid = integrate_scans(empty_grid(spec, device=dev), model,
                           type(scans)(*(x[:split] for x in scans)), gt[:split])
    free = pf.free_cells(grid)

    def tick(t, u):
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        state = relocalize(u, free, "icp", grid, None, model, scans.ranges[t], valid, keep)
        return pf.estimate(state).cpu().numpy()

    for k in range(min(int(mix["warmup_ticks"]), ticks_per_lap)):
        tick(split + 1 + k, draws[0, k])
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
            d = len(laps) % draws.shape[0]
            ests = []
            laps.append((d, ests))
            for k in range(ticks_per_lap):
                a = time.perf_counter()
                with spans("tick"):
                    est = tick(split + 1 + k, draws[d, k])
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

    def program_scored(poses, t):
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        zero = torch.zeros(poses.shape[0], device=dev)
        equal = zero - torch.logsumexp(zero, dim=0)
        scored = pf.update_raycast_icp(pf.ParticleState(poses, equal), grid, model,
                                       scans.ranges[t], valid)
        kept = pf.global_relocalize_raycast_icp(poses, grid, model, scans.ranges[t], valid, keep)
        return scored, kept

    def program_samples(u):
        return pf.free_space_poses(free, spec, u)

    checks, notes = compare(cell, log, split, draws, laps, grid.log_odds.cpu().numpy(),
                            int(free.numel()), program_samples, program_scored, dev)
    all_ests = [(np.stack(e), split + 1) for _, e in laps if e]
    dt, dr = (np.concatenate(x) for x in zip(*(
        harness.pose_gaps(e, log.gt[s:s + len(e)]) for e, s in all_ests)))
    found = float(np.mean((dt <= FOUND_M) & (dr <= FOUND_RAD)))
    n_ticks = len(seconds)
    return harness.Outcome(
        attempted=n_ticks, failed=int(sum(not np.all(np.isfinite(e)) for _, x in laps
                                          for e in x)),
        end_to_end={"localize_tick_p95_ms": 1e3 * harness.percentile(seconds, 95),
                    "setup_s": setup_s},
        checks=checks, memory_peak_bytes=int(peak), spans=spans.seconds,
        counters={"ticks": n_ticks, "laps": len(laps), "particles": samples,
                  "particle_points": samples * n_points, "n_beams": model.n_beams,
                  "icp_iters": int(loc["icp_iters"]), "free_cells": int(free.numel()),
                  **program},
        trace=traced[0] if traced else None,
        notes=[f"{n_ticks} ticks in {len(laps)} laps of {ticks_per_lap} in {window:.3f} s; "
               f"tick p50 {1e3 * harness.percentile(seconds, 50):.4f} ms, p95 "
               f"{1e3 * harness.percentile(seconds, 95):.4f} ms; relocalized estimates within "
               f"{FOUND_M} m and {FOUND_RAD} rad of ground truth: {100 * found:.2f} % of ticks",
               f"grid {spec.width} x {spec.height} at {res} m, {int(free.numel())} free cells; "
               f"{samples} samples x {model.n_beams} beams, {keep} kept, "
               f"{int(loc['icp_iters'])} ICP iterations; valid points "
               f"{n_points / max(n_ticks, 1):.1f} a tick; program counters a tick: "
               + (", ".join(f"{k} {v / n_ticks:.2f}" for k, v in program.items())
                  if program and n_ticks else "none"),
               *notes])


def update_gaps(got, want) -> dict:
    """The 99th percentile over the samples of the log-weight gap and of
    the nudged poses' translation and rotation gaps; how many samples moved
    more than 1e-4 in any of them, the log-weights taken less their median
    gap (a sample that matched one point more moves every normalized
    log-weight a little); and how many failed their match on the
    reference's side: a failed match weighs 1e-6 and a held one at least
    20 / 361 of the points, so a failed sample lies more than 7 below the
    largest log-weight, and where every sample failed all are equal."""
    w = want.log_w.double().cpu().numpy()
    n_failed = int(np.sum(w < w.max() - 7.0)) or (w.size if np.ptp(w) == 0 else 0)
    gap = got.log_w.double().cpu().numpy() - w
    dw = np.abs(gap)
    dt, dr = harness.pose_gaps(got.poses.double().cpu().numpy(), want.poses.double().cpu().numpy())
    return {"upd_logw_p99": float(np.percentile(dw, 99)),
            "upd_pose_p99_m": float(np.percentile(dt, 99)),
            "upd_pose_p99_rad": float(np.percentile(dr, 99)),
            "moved": int(np.sum((np.abs(gap - np.median(gap)) > 1e-4) | (dt > 1e-4)
                                | (dr > 1e-4))),
            "failed": n_failed}


def compare(cell, log, split: int, draws: torch.Tensor, laps: list, prog_grid: np.ndarray,
            prog_free: int, program_samples, program_scored, dev) -> tuple[list, list]:
    """The checks of a window's ``laps`` (``(draw set, estimates)``)
    against the reference, and lines for stderr. ``program_samples(u)``
    draws the program's samples from a tick's uniforms;
    ``program_scored(samples, t)`` scores the reference's samples on the
    program's side, ``(scored, kept)``."""
    loc, check = cell.cfg["localization"], int(cell.mix["check_ticks"])
    values = dict.fromkeys(("map_gap", "free_cells_gap", "sample_gap_m", "sample_gap_rad",
                            "upd_logw_p99", "upd_pose_p99_m", "upd_pose_p99_rad",
                            "kept_logw_mean", "kept_logw_p99", "est_gap_m", "est_gap_rad",
                            "top8_flips"), 0.0)
    moved, failed, same_top, ref_at = [0], [], {}, {}

    for d in sorted({d for d, _ in laps}):
        def visit(k, samples, scored, kept):
            t = split + 1 + k
            mine = program_samples(draws[d, k])
            dt, dr = harness.pose_gaps(mine.double().cpu().numpy(),
                                       samples.double().cpu().numpy())
            values["sample_gap_m"] = max(values["sample_gap_m"], float(dt.max()))
            values["sample_gap_rad"] = max(values["sample_gap_rad"], float(dr.max()))
            got, got_kept = program_scored(samples.float(), t)
            gaps = update_gaps(got, scored)
            moved[0] = max(moved[0], gaps.pop("moved"))
            failed.append(gaps.pop("failed"))
            for name, v in gaps.items():
                values[name] = max(values[name], v)
            by_rank = np.abs(got_kept.log_w.double().cpu().numpy()
                             - kept.log_w.double().cpu().numpy())
            values["kept_logw_mean"] = max(values["kept_logw_mean"], float(by_rank.mean()))
            values["kept_logw_p99"] = max(values["kept_logw_p99"],
                                          float(np.percentile(by_rank, 99)))
            mine_top = top_indices(got.log_w).to(scored.log_w.device)
            same_top[d, k] = set(mine_top.tolist()) == set(top_indices(scored.log_w).tolist())
            ref_at[d, k] = ref.estimate_at(scored, mine_top)

        want, ref_grid, ref_free = ref.lap(log, split, loc, draws[d], check, dev, visit=visit)
        values["map_gap"] = max(values["map_gap"], float(np.abs(prog_grid - ref_grid).max()))
        values["free_cells_gap"] = max(values["free_cells_gap"], float(abs(prog_free - ref_free)))
        reached = 0
        for dd, ests in laps:
            if dd != d:
                continue
            reached = max(reached, min(len(ests), len(want)))
            for k in range(min(len(ests), len(want))):
                gt_, gr = harness.pose_gaps(ests[k], ref_at[d, k])
                values["est_gap_m"] = max(values["est_gap_m"], float(gt_))
                values["est_gap_rad"] = max(values["est_gap_rad"], float(gr))
        values["top8_flips"] += sum(not same_top[d, k] for k in range(reached))
    checks = [harness.Check(k, v, float(cell.limits[k])) for k, v in values.items()]
    notes = [f"checked ticks: at most {moved[0]} samples a tick with a log-weight or a pose "
             f"more than 1e-4 from the reference's; failed matches (reference) "
             f"{min(failed, default=0)}-{max(failed, default=0)} of "
             f"{int(loc['samples'])} a tick; top-8 set differs on "
             f"{int(values['top8_flips'])} of {len(same_top)} checked ticks"]
    return checks, notes


def control(cell: harness.Cell) -> list:
    """The checks of ``check_ticks`` ticks with the reference in bfloat16
    in the program's place: its map and free cells, its samples from the
    same uniforms, its scoring of the float32 reference's samples, and its
    own lap's estimates."""
    dev = torch.device(cell.device)
    loc = cell.cfg["localization"]
    log = traffic.make_log(cell.cfg, cell.seed, cell.n_scans)
    split = log.ranges.shape[0] // 2
    low = torch.bfloat16
    check = int(cell.mix["check_ticks"])
    draws = make_uniforms(cell.seed, 1, log.ranges.shape[0] - split - 1, int(loc["samples"]), dev)
    ests, grid, n_free = ref.lap(log, split, loc, draws[0], check, dev, low)
    model, scans, _, low_grid = ref_setup.setup(log, split, float(loc["resolution"]), dev, low)
    low_free = ref.free_cells(low_grid.log_odds)

    def low_samples(u):
        return ref.sample(low_free, low_grid.spec, u.to(low))

    def low_scored(poses, t):
        valid = ~scans.bad[t] & (scans.ranges[t] < model.max_range)
        return ref.relocalize(poses.to(low), low_grid, model, scans.ranges[t], valid,
                              int(loc["particles"]), bool(loc["nudge"]), int(loc["icp_iters"]),
                              float(loc["icp_max_corr"]))

    return compare(cell, log, split, draws, [(0, list(ests))], grid, n_free, low_samples,
                   low_scored, dev)[0]
