"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. device — require CUDA; print the card and its power limit;
2. build — compile the fused PSM kernel (K1, two entries) and the sparse
   correlative score-volume kernel from ``laser_slam_tpu_torch/csrc``
   with nvcc for sm_90a;
3. kernel parity at full size — K1's batch entry against the plain
   PyTorch matcher on the card, and its error-index epilogue against the
   plain ``error_index``: 2671 consecutive LMS211 pairs of the synthetic
   intel-lab-shaped log, and 512 pairs at 361 and 541 beams; batch
   timings. Then ``[correlative]``: the score-volume kernel against its
   plain version (count raster and grouped conv) at pass 2's shapes, 181
   and 361 beams, bit for bit, with the times of both and the bound;
4. main paths — ``laser_slam_tpu_torch.cli odometry`` on the 2672-scan
   synthetic CARMEN log on ``cuda``: read → preprocess → keyframe
   odometry (K1's chain entry: pass 1 in one launch; then the ±π
   correlative re-match of flagged steps, one launch of the score-volume
   kernel a chunk, by count and in the trace) → ATE/RPE → occupancy map →
   PNG; and ``cli odometry --pairwise`` (K1's batch entry, one launch of
   2671 pairs). Then the keyframe odometry again by the step-loop route
   (``chain="steps"``, the chain entry's plain version on the card), held
   against the chain's poses and flags over the whole log; K1's batch
   entry and epilogue against the plain versions on the steps' own
   two-pair inputs (with their nonzero priors); timings of the chain and
   the step; a ``torch.profiler`` trace of the keyframe odometry (kernel
   counts, device busy and idle share); each layer of the path again,
   alone, for its share of the time;
5. ``laser_slam_tpu_torch.cli slam`` on the same log on ``cuda`` at
   ``SlamConfig()`` defaults: keyframe
   odometry (K1's chain entry) → submaps → signature gate → wide clouds
   → eight waves of propose, verify in chunks of 32, robust solve →
   re-attachment. Held: the chain entry launched, all waves ran, a
   strict loop banked and used, finite poses, SLAM ATE below the run's
   odometry ATE; the used loops are classified against the ground
   truth; every score volume launches the sparse kernel once, and the
   first of pass 2 and of each loop-closure lane equals the conv's bit for
   bit. Then one wave under ``torch.profiler``: the device time of the
   hot spots (nearest-two search, score volume, peak suppression, sorts
   and dense solves);
6. the online path, on the same log at ``SlamConfig()`` defaults:
   ``SlamV1(work_mode="mapping")`` as shipped (async backend on a worker
   thread with a CUDA stream of its own, the filter and the live map on)
   fed all scans through ``feed_scan_main`` in real time (10 Hz) with a
   local-map and an obstacle callback, then ``stop()`` and ``flush(final_round=True)``:
   per-scan latency with and without a round in flight, the scheduler's
   counters, the rounds' walls, ATE before and after. K1's two-pair
   entry launches once a scan; every 16th scan's inputs are held against
   the plain versions. Every score volume launches the sparse kernel once;
   the rounds' first volumes equal the conv's bit for bit, the frontend's
   deep step (B = 1, where the conv was cuDNN's) within 1e-5 of its sum. The same session with the synchronous backend on
   the first 1000 scans (the frontends must agree until a round applies);
   a checkpoint at scan 1000 resumed and fed 200 more against the
   uninterrupted session; a profiler trace of 200 scans; each layer of a
   scan alone;
7. localization: ``cli localize`` at 4096 particles, and 50 ticks of
   ``cli localize --model beam`` at 2 cm, one ray-march launch a tick;
   the likelihood field, global relocalization from 10,000 samples, 200
   particle-filter ticks timed with CUDA events, one ``update_beam`` (one
   ray-march launch on the card); the card's tick against the same
   functions on the CPU with the same draws; the beam model's ray-march
   kernel at one tick of the beam-model cell's shape against the dense
   ladder, bit for bit, both timed beside the least time; at the end, the
   point-ICP nearest-two search kernel at one iteration of the ray-cast +
   ICP cell's shape against the plain ``[b, N, N]`` block, bit for bit,
   both timed beside the least time, with its launches on each main path
   (``cli odometry``'s pass 2 polish, 15 a chunk; ``[slam]``, ``[online]``,
   the ``[tcp]`` client, ``[robot]``), one a search of CUDA float32 clouds
   and none of them on the plain block; pass 2's polish at 181 and 361
   beams is held bit for bit to the plain block in ``[correlative]``;
8. the distributed topology (``[tcp]``): ``cli serve`` on ``cuda`` in a
   process of its own and ``cli client`` on ``cuda`` streaming the whole
   log to it over localhost TCP; the client's K1 two-pair launches, the
   server's rounds, loops and trajectory (its ATE below the client's raw
   odometry chain's), per-scan latency, the wire bytes;
9. the other matchers (``[matchers]``): polar ICP and PL-ICP over the
   log's consecutive pairs, ``odometry_pairwise(use_icp=True)`` beside the
   PSM route, the card against the CPU on the first 300 pairs;
10. the ICP-verified branch of ``slam_offline`` (``[slam-icp]``,
    ``use_correlative=False``) with ``use_submaps`` off and on, held to
    the JAX package's loops and ATE from the same front end;
11. feature-RANSAC loop verification (``[features]``) over one round's
    candidates and the pairs of neighbouring anchors, the card against
    the CPU under the same draws;
12. the robot application path (``[robot]``): ``RobotController`` in
    mapping mode with the floor grid and its portal, fed 600 scans of the
    log flat out with ``control_tick`` after each and a localhost console
    (PING, GOTO, POSE, STATE, MAP); K1's two-pair entry once a scan; its
    local map against the CPU's; one plan's time and device operations.
    Then a closed drive of ``TaskEngine`` on the card (scans ray-cast at
    the true pose), held to reach its goal outside the inflated
    obstacles, under the zones' speed caps, its first plan and its dodges
    the CPU's;
13. the Kalman and landmark filters (``[fusion]``): a range-bearing
    covariance filter through ``torch.func.jacfwd`` and the UdU filter
    against the covariance filter (1000 steps each), EKF-SLAM with 128
    landmark slots (1000 steps, up to 8 sightings a step) and fastSLAM
    with 4096 particles × 64 slots (300 steps), every draw from one CPU
    generator: EKF-SLAM on the card against the CPU, fastSLAM's poses up
    to its first resample against the CPU, each filter against the
    simulated truth, ms and device operations a step, peak memory;
14. ``parallel/`` on a one-rank NCCL group (``[parallel]``):
    ``sharded_batch_match`` over the log's 2671 pairs with PSM (K1's batch
    entry), polar ICP and PL-ICP, each equal to the undistributed call;
    ``distributed_optimize`` against ``optimize`` on ``[slam]``'s anchor
    graph (dense route) and on all scans' odometry chain with 512 loops
    (CG route), within ``optimize``'s own run-to-run spread;
    ``training_step`` over 512 pairs in the dry-run layout; two ranks on
    the one card as two processes over gloo;
15. the bundled logs (intel-lab, fr079, mit-cscail), each when present at
    the repo's reference-data location (``REFERENCE_DATA``, as in
    ``tests/conftest.py``).

The last three lines of stdout are the kernels' JSON
record, the card's name and power limit, and the device JSON line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

# Keyframe-odometry ATE of the JAX package (laser_slam_tpu) on the
# synthetic log ``tools/synthetic_log.py`` writes with its defaults
# (2672 scans, seed 0): odometry_keyframe(deep_chunk=4, timestamps),
# measured on the CPU (jax 0.9.0). The port must stay within
# 1.10 × this + 0.02 m.
JAX_SYNTHETIC_ATE = 3.931748628616333
ATE_FACTOR, ATE_SLACK = 1.10, 0.02
# The JAX package's ICP-verified branch (use_correlative=False) on the same
# log, by use_submaps: (loops kept in the last round, SLAM ATE in m), measured
# on the CPU with jax 0.9.0 by tools/icp_branch_reference.py from two front
# ends: JAX's own keyframe odometry (baselines/jax_synthetic_front.npz,
# odometry ATE 3.9317 m) and the port's on an NVIDIA H100 80GB HBM3
# (baselines/port_card_synthetic_front.npz, odometry ATE 4.1497 m; this
# script holds its own run's front end to that file). The branch amplifies
# its input (53 loops against 1), so the port is held to JAX from the same
# front end: the same loop count, the ATE within SLAM_ICP_ATE_ATOL (float32
# round-off of the two packages' rounds: 1e-4 m measured), and from JAX's
# front end below that odometry's ATE.
JAX_SLAM_ICP = {False: (53, 3.592615842819214), True: (60, 3.473823308944702)}
JAX_SLAM_ICP_FROM_CARD_FRONT = {False: (1, 4.222824573516846), True: (5, 4.207590103149414)}
JAX_FRONT_ODOMETRY_ATE = 3.931748628616333
SLAM_ICP_ATE_ATOL = 0.01
# The card's keyframe odometry against the committed copy of it: the same
# flags, every pose within this (the chain kernel is deterministic).
CARD_FRONT_ATOL = 1e-4
# Feature-RANSAC verification of the 531 pairs of anchors one and two apart
# on the synthetic log: at least this many accepted on the card (a floor well
# below what the verifier accepts there with its own draws on the CPU).
FEATURES_MIN_NEAR_ACCEPTED = 40
# The bundled logs' location, as in tests/conftest.py, and the recorded
# keyframe-odometry ATE of the JAX package on each (tests/test_accuracy.py)
# with the regression factor applied there.
REFERENCE_DATA = "/root/reference/data"
REFERENCE_ODOMETRY_ATE = {"intel-lab": 8.97, "fr079": 3.00, "mit-cscail": 1.81}
# K1 against the plain matcher on the same card: the same fail flags,
# every pose within 1e-4 (float32 op order: fused multiply-adds, block
# reductions) and every mean residual within rtol 1e-4, as in
# tests/test_torch_cuda.py.
POSE_ATOL, ERR_RTOL = 1e-4, 1e-4
# K1 on the card against the plain matcher on the CPU: the compiled-parity
# bounds of tests/test_pallas_psm.py::test_pallas_compiled_parity_on_intel,
# because float transcendentals differ between the devices in the last bit.
P50_T, P99_T, P50_R_DEG, P99_R_DEG, MAX_KERNEL_ONLY_FAILS = 5e-3, 0.15, 0.1, 2.0, 5
# Every this-many keyframe steps of the step-loop route, K1 is held to the
# plain matcher on that step's own inputs.
STEP_SAMPLE = 16
# The online session is fed in real time, one scan every 100 ms: the log's
# own scan period (tools/synthetic_log.DT), as a robot's sensor feeds it. Fed
# as fast as the frontend takes them, the scans starve the backend's worker
# of the interpreter lock: 5-7 rounds start instead of 20 and more, and about
# one such session in six ends with wrong loops in use and an ATE above its
# odometry's (tools/online_rounds_probe.py shows both schedules).
REPLAY_PERIOD = 0.1
# K1's chain entry against the step loop on the card, whole log: flags
# identical; poses within 1e-3 m / rad. Both routes run the kernel's one
# arithmetic for the matches and error indices; only the pose composition
# differs (ATen's kernels against the chain kernel's registers), float32
# round-off carried along 2671 steps.
CHAIN_ATOL = 1e-3
# [robot]: the robot application path at full width. RobotController in
# mapping mode is fed the log's first ROBOT_SCANS scans flat out, a console
# on localhost sends its commands after scan ROBOT_CONSOLE_AT, the GOTO goal
# is the log's pose nearest ROBOT_GOTO_WORLD (room 2; the log starts in the
# hall). The floor grid is the whole synthetic floor at 0.05 m with a 0.5 m
# margin. The card's local map is held to the CPU's fed the same scans and
# poses: the same cells (refmath rounds alike on both), sums of atomic adds
# in another order.
ROBOT_SCANS = 600
ROBOT_CONSOLE_AT = 20
ROBOT_GOTO_WORLD = (9.5, 9.8)
ROBOT_GRID_RES, ROBOT_GRID_MARGIN = 0.05, 0.5
ROBOT_MAP_ATOL = 1e-4
# [robot] drive: a start in room 1, a leg through its doorway into the hall
# and one along the hall to below room 3's doorway, each snapped to the log's
# nearest ground-truth pose. Each leg passes its doorway head-on: at its
# default 0.6 m look-ahead, pure pursuit cuts a path's corner by up to
# ~0.3 m, so a leg that turns around a door jamb (room 1 → room 2) brings
# the robot within its 0.3 m radius of the jamb and ends FAILED, in the JAX
# package as in the port (tests/test_torch_app.py holds both to the same
# ticks). DRIVE_DT is the control period.
DRIVE_LEGS_WORLD = ((4.2, 9.8), (3.5, 6.0), (14.5, 6.0))
DRIVE_MAX_TICKS, DRIVE_DT, DRIVE_DODGE_EVERY = 1500, 0.1, 50
# [fusion]: the Kalman and landmark filters at full size. A world of
# FUSION_LANDMARKS landmarks in a FUSION_WORLD m square; the robot drives a
# circle of FUSION_RADIUS m about its centre, FUSION_STEP m a step with
# noise FUSION_MOTION_SIGMA (x, y, θ), and sights the nearest landmarks
# within FUSION_SENSOR_RANGE m, at most FUSION_SIGHTINGS a step, with
# noise FUSION_OBS_SIGMA (range, bearing). EKF-SLAM holds FUSION_EKF_SLOTS
# slots (a 259-dimensional state); fastSLAM FUSION_PARTICLES particles (the
# particle filter's count in [localize]) × FUSION_FAST_SLOTS slots for
# FUSION_FAST_STEPS steps. Operations a step are read from a profiler trace
# of FUSION_TRACE_STEPS more steps.
FUSION_SEED, FUSION_STEPS, FUSION_TRACE_STEPS = 0, 1000, 10
FUSION_LANDMARKS, FUSION_WORLD, FUSION_RADIUS, FUSION_STEP = 60, 40.0, 12.0, 0.1
FUSION_SENSOR_RANGE, FUSION_SIGHTINGS = 10.0, 8
FUSION_MOTION_SIGMA = np.array([0.01, 0.01, 0.002])
FUSION_OBS_SIGMA = np.array([0.05, 0.01])
FUSION_EKF_SLOTS, FUSION_PARTICLES, FUSION_FAST_SLOTS, FUSION_FAST_STEPS = 128, 4096, 64, 300
FUSION_CPU_STEPS = 100
# Bounds of [fusion], set with margin over an H100 run (NVIDIA H100 80GB
# HBM3, 700.00 W; measured in brackets): the covariance filter's mean
# position error, m [0.019]; the UdU filter's mean against the covariance
# filter's [2.9e-6]; the card against the CPU on the same inputs and draws,
# EKF-SLAM means after FUSION_CPU_STEPS steps and fastSLAM poses up to the
# first resample [1.4e-5, 3e-8]; the mean landmark error of EKF-SLAM, m
# [0.150] (fastSLAM: twice it [0.093]); fastSLAM's pose error, m [0.187].
FUSION_POS_ERR, FUSION_UDU_ATOL, FUSION_CARD_CPU_ATOL, FUSION_LM_ERR = 0.05, 1e-4, 1e-3, 0.25
FUSION_FAST_POS_ERR = 0.5
# [parallel]: the CG-route graph takes PARALLEL_CG_LOOPS loops from the
# ground truth between scans at least PARALLEL_CG_MIN_GAP apart;
# training_step runs PARALLEL_TRAIN_PAIRS pairs in the dry-run layout of
# the JAX package's multi-chip dry run (tools/torch_multiproc_worker.py). The
# distributed solve is held to optimize within max(2 × optimize's own
# run-to-run spread, PARALLEL_SOLVE_FLOOR) m, the spread read from two plain
# runs (ROADMAP Queue 3 measured 3.8e-6 to 5.3e-6 m on cli slam's solves).
PARALLEL_CG_LOOPS, PARALLEL_CG_MIN_GAP, PARALLEL_TRAIN_PAIRS = 512, 200, 512
PARALLEL_SOLVE_FLOOR = 1e-4
# Published peaks of one H100 SXM (NVIDIA's data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth. The bounds below are stated against them.
PEAK_FP32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# Floating-point operations K1 needs per beam, transcendentals counted as one
# each: a projection (transform 12, atan2 and lift 2, pair quantities 8,
# candidate bins 6, ~2 covered bins x 6), one shift of the orientation search
# (subtract, abs, two adds), the translation sums, the error-index sums.
OPS_PROJECT, OPS_SHIFT, OPS_TRANSLATE, OPS_INDEX = 40, 4, 22, 8
# Bytes per match beside the scans: prior in, pose, residual, fail flag and
# iteration count out; the error index's two floats and a count; a chain
# step's pose, three flags and two iteration counts.
MATCH_IO_BYTES, INDEX_OUT_BYTES, CHAIN_STEP_OUT_BYTES = 12 + 12 + 4 + 1 + 4, 12, 12 + 3 + 8


# ``torch.profiler.record_function`` ranges in the port that mark its hot
# spots: their device seconds are read from a trace.
HOT_SPOTS = {
    "h1_nearest_two": "H1 distance matrix + two argmins (ops/icp_points)",
    "h2_score_volume_conv": "H2 score volume: the sparse kernel corr_volume_kernel (ops/correlative)",
    "h3_peak_nms": "H3 max_pool3d + stable sort (ops/correlative)",
    "h4_sort": "H4 voxel-key sorts (graph/submap.reduce_group)",
    "h4_solve": "H4 dense LU solves (graph/solve)",
}
# ATen operators whose device seconds the wave trace also lists.
ATEN_OPS = ("aten::sort", "aten::argmin", "aten::cudnn_convolution", "aten::max_pool3d_with_indices",
            "aten::_conv_depthwise2d", "aten::linalg_solve_ex", "aten::index_put_",
            "aten::scatter_", "aten::gather", "laser_slam_tpu_torch::corr_volume")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, after a warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def pose_diff(a, b):
    d = a.pose.cpu().numpy().astype(np.float64) - b.pose.cpu().numpy()
    dt = np.linalg.norm(d[:, :2], axis=1)
    dr = np.abs((d[:, 2] + np.pi) % (2 * np.pi) - np.pi)
    return dt, dr


def parity(fused, plain, label):
    """Holds K1's result to the plain matcher's on the same card and the
    same pairs: identical fail flags, poses within ``POSE_ATOL`` (angle
    wrapped), mean residuals within ``ERR_RTOL``. Returns the stats."""
    fail_k = fused.fail.cpu().numpy()
    fail_p = plain.fail.cpu().numpy()
    d = (fused.pose.cpu().numpy().astype(np.float64) - plain.pose.cpu().numpy())
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    err_k, err_p = fused.err.cpu().numpy(), plain.err.cpu().numpy()
    stats = {
        "pairs": int(fail_k.shape[0]), "fails": int(fail_p.sum()),
        "fail_mismatches": int((fail_k != fail_p).sum()),
        "max_abs_err": float(np.abs(d).max()),
        "max_err_rel": float(np.max(np.abs(err_k - err_p) / np.maximum(np.abs(err_p), 1e-30))),
    }
    phase("parity", f"{label} {json.dumps(stats)}")
    if stats["fail_mismatches"] or not stats["max_abs_err"] <= POSE_ATOL:
        raise AssertionError(f"K1 disagrees with the plain matcher on {label}: {stats}")
    np.testing.assert_allclose(err_k, err_p, rtol=ERR_RTOL, err_msg=label)
    return stats


def cross_device_parity(fused, plain_cpu, label):
    """Holds K1's result on the card to the plain matcher's on the CPU, at
    the compiled-parity bounds. Returns the stats."""
    fail_k = fused.fail.cpu().numpy()
    fail_p = plain_cpu.fail.numpy()
    ok = ~fail_k & ~fail_p
    dt, dr = pose_diff(fused, plain_cpu)
    stats = {
        "pairs": int(fail_k.shape[0]),
        "t_p50": float(np.percentile(dt[ok], 50)), "t_p99": float(np.percentile(dt[ok], 99)),
        "r_p50_deg": float(np.degrees(np.percentile(dr[ok], 50))),
        "r_p99_deg": float(np.degrees(np.percentile(dr[ok], 99))),
        "fails_plain": int(fail_p.sum()), "fails_kernel": int(fail_k.sum()),
        "kernel_only_fails": int((fail_k & ~fail_p).sum()),
        "max_abs_err": float(np.abs((fused.pose.cpu() - plain_cpu.pose).numpy())[ok].max()),
    }
    good = (
        stats["t_p50"] < P50_T and stats["t_p99"] < P99_T
        and stats["r_p50_deg"] < P50_R_DEG and stats["r_p99_deg"] < P99_R_DEG
        and stats["kernel_only_fails"] <= MAX_KERNEL_ONLY_FAILS and ok.sum() > 0
    )
    phase("parity", f"{label} {json.dumps(stats)}")
    if not good:
        raise AssertionError(f"K1 disagrees with the plain matcher on {label}: {stats}")
    return stats


def index_parity(got, want, label):
    """Holds the epilogue's ``(err_x, err_y, n)`` to the plain
    ``error_index``: ``n`` equal, the errors within ``ERR_RTOL``. Returns
    the largest relative error."""
    np.testing.assert_array_equal(got[2].cpu().numpy(), want[2].cpu().numpy(), label)
    rel = 0.0
    for g, w in zip(got[:2], want[:2]):
        g, w = g.cpu().numpy(), w.cpu().numpy()
        np.testing.assert_allclose(g, w, rtol=ERR_RTOL, err_msg=label)
        rel = max(rel, float(np.max(np.abs(g - w) / np.maximum(np.abs(w), 1e-30))))
    phase("parity", f"{label}: error index n equal, max rel err {rel:.3g}")
    return rel


def bound_ms(model, iters_total, matches, n_bytes, with_index=True):
    """Least milliseconds the card could take for ``matches`` PSM matches
    that ran ``iters_total`` solver iterations in all and moved
    ``n_bytes``: the larger of operations over the float32 peak and bytes
    over the memory rate. Returns ``(ms, "operations" | "bytes")``."""
    n, shifts = model.n_beams, 2 * model.window + 1
    ops = iters_total * n * (2 * OPS_PROJECT + shifts * OPS_SHIFT + OPS_TRANSLATE)
    if with_index:
        ops += matches * n * (OPS_PROJECT + OPS_INDEX)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS * 1e3, n_bytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def n_bytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def trace(fn, host_ops=None):
    """Runs ``fn()`` under ``torch.profiler`` and returns ``(wall seconds,
    number of device operations, device-busy seconds as the union of their
    intervals, {kernel: (count, seconds)})``, K1's two entries by name and
    the sparse score-volume kernel by name, everything else as ``other``. With a dict ``host_ops``, it is filled
    with ``{name: (calls, device seconds)}`` of the host-side ranges and
    operators named in ``HOT_SPOTS`` and ``ATEN_OPS``: the device time of
    the kernels each launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device-side events; a record_function range's mirror on the device
    # timeline (the hot spots and the program's other spans) is not an
    # operation.
    ranges = set(HOT_SPOTS) | {e.name for e in prof.events()
                               if getattr(e, "is_user_annotation", False)}
    ops = [e for e in prof.events()
           if str(e.device_type).endswith("CUDA") and e.time_range.end > e.time_range.start
           and e.name not in ranges]
    if host_ops is not None:
        for e in prof.events():
            if str(e.device_type).endswith("CPU") and (e.name in HOT_SPOTS or e.name in ATEN_OPS):
                calls, seconds = host_ops.get(e.name, (0, 0.0))
                host_ops[e.name] = (calls + 1, seconds + e.device_time_total / 1e6)
    by_name, busy, edge = {}, 0.0, None
    for e in sorted(ops, key=lambda e: e.time_range.start):
        key = next((k for k in ("psm_chain_kernel", "psm_match_kernel", "corr_volume_kernel")
                    if k in e.name), "other")
        count, seconds = by_name.get(key, (0, 0.0))
        by_name[key] = (count + 1, seconds + (e.time_range.end - e.time_range.start) / 1e6)
        start = e.time_range.start if edge is None else max(e.time_range.start, edge)
        busy += max(0.0, e.time_range.end - start) / 1e6
        edge = e.time_range.end if edge is None else max(edge, e.time_range.end)
    return wall, len(ops), busy, by_name


def cat_results(results, psm):
    return psm.MatchResult(*(torch.cat(x) for x in zip(*results)))


def pairs(scans, S):
    return S.Scan(*(x[:-1] for x in scans)), S.Scan(*(x[1:] for x in scans))


def host_s(fn):
    """``(fn(), seconds)`` on the host clock, synchronised on both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def volume_calls(keep=None):
    """Counts the calls of ``correlative.correlative_score_volume`` while
    open (from any thread) and zeroes the sparse kernel's launch count on
    entry: on the card every call must launch ``corr_volume_kernel`` once,
    which :func:`check_volume_launches` holds afterwards. With a dict
    ``keep``, the first call's arguments of each ``(overlap_norm, B == 1,
    G)`` are kept in it."""
    import inspect

    from laser_slam_tpu_torch.ops import correlative
    from laser_slam_tpu_torch.ops.cuda import correlative_kernel as V

    plain, calls = correlative.correlative_score_volume, [0]
    sig = inspect.signature(plain)

    def counting(*args, **kw):
        calls[0] += 1
        if keep is not None:
            a = sig.bind(*args, **kw)
            a.apply_defaults()
            grid = a.arguments["grid"]
            keep.setdefault((a.arguments["overlap_norm"], grid.shape[0] == 1, grid.shape[-1]),
                            dict(a.arguments))
        return plain(*args, **kw)

    correlative.correlative_score_volume = counting
    V.score_volume_sparse.launches = 0
    try:
        yield calls
    finally:
        correlative.correlative_score_volume = plain


def check_volume_launches(calls, label) -> int:
    """Holds the sparse kernel's launches since :func:`volume_calls` opened
    to the score-volume calls it counted; returns them."""
    from laser_slam_tpu_torch.ops.cuda import correlative_kernel as V

    launches = V.score_volume_sparse.launches
    if launches != calls[0] or launches < 1:
        raise AssertionError(f"{label}: {calls[0]} score-volume calls launched the sparse kernel "
                             f"{launches} times")
    return launches


@contextlib.contextmanager
def search_calls():
    """Counts the point-ICP correspondence searches
    (``icp_points._nearest_two``) while open, from any thread, and zeroes
    the nearest-two kernel's launch count on entry. Yields ``[kernel,
    plain]``: the searches of CUDA float32 clouds with points, each of
    which must launch ``nearest_two_kernel`` once (held by
    :func:`check_search_launches`), and the others, which take the plain
    block."""
    import threading

    from laser_slam_tpu_torch.ops import icp_points
    from laser_slam_tpu_torch.ops.cuda import icp_nearest_kernel as NK

    search, calls, lock = icp_points._nearest_two, [0, 0], threading.Lock()

    def counting(q, ref_pts, ref_valid):
        kernel = icp_points.searches_on_kernel(q, ref_pts) and q.shape[0] * q.shape[1] > 0
        with lock:
            calls[0 if kernel else 1] += 1
        return search(q, ref_pts, ref_valid)

    icp_points._nearest_two = counting
    NK.nearest_two.launches = 0
    try:
        yield calls
    finally:
        icp_points._nearest_two = search


def check_search_launches(calls, label, expect=None) -> int:
    """Holds the nearest-two kernel's launches since :func:`search_calls`
    opened to the searches it counted on the kernel's path (and to
    ``expect``, where the path's iterations are known): at least one, one
    a search, none of the path's searches on the plain block. Returns
    them."""
    from laser_slam_tpu_torch.ops.cuda import icp_nearest_kernel as NK

    launches = NK.nearest_two.launches
    if launches != calls[0] or launches < 1 or calls[1] or expect not in (None, launches):
        raise AssertionError(f"{label}: {calls[0]} searches of CUDA float32 clouds (expected "
                             f"{expect}) launched the nearest-two kernel {launches} times; "
                             f"{calls[1]} searches took the plain block")
    return launches


def volume_parity(a, label, exact=True):
    """The sparse kernel against its plain version (the count raster and
    the grouped conv) on the arguments ``a`` of one
    ``correlative_score_volume`` call on the card, both planes with
    ``overlap_norm``. ``exact``: the volumes equal bit for bit (PyTorch's
    depthwise conv, B > 1); otherwise (B = 1, where the conv is cuDNN's)
    within 1e-5 of the volume's largest sum. Returns the largest
    difference."""
    from laser_slam_tpu_torch.ops import correlative
    from laser_slam_tpu_torch.ops.cuda import correlative_kernel as V

    grid, n_steps = a["grid"], a["n_steps"]
    g = grid.shape[-1]
    ix, iy, inb = correlative._rotated_cells(a["pts"], a["ok"], a["thetas"], a["base_xy"],
                                             a["res"], a["half_extent"], g)
    planes = (torch.stack([grid, correlative._cover(grid, a["res"], a["overlap_radius"])])
              if a["overlap_norm"] else grid[None])
    got = V.score_volume_sparse(planes, torch.where(inb, iy * g + ix, -1).to(torch.int32),
                                n_steps)
    want = correlative._score_volume_conv(planes, ix, iy, inb, n_steps)
    equal = torch.equal(got, want)
    diff = float((got - want).abs().max())
    top = float(want.abs().max())
    same_arg = torch.equal(got.flatten(2).argmax(-1), want.flatten(2).argmax(-1))
    phase("correlative", f"{label}, B={grid.shape[0]} K={a['thetas'].shape[-1]} "
                         f"T={2 * n_steps + 1} G={g} N={a['pts'].shape[1]} planes "
                         f"{planes.shape[0]}: kernel vs plain conv equal {equal}, max |d| "
                         f"{diff:.3g} of {top:.4g}, flat argmax equal {same_arg}")
    if not (equal if exact else diff <= 1e-5 * top):
        raise AssertionError(f"the sparse volume kernel differs from the conv on {label} by {diff}")
    return diff


def correlative_phase(log, scans, synth, smi):
    """``[correlative]``: the sparse score-volume kernel against its plain
    version at pass 2's shapes (128 consecutive pairs, 72 rotations across
    ±π, ``match_correlative``'s ±1.2 m window on the 256 × 256 grid) at 181
    and 361 beams, bit for bit; the kernel's time, the plain version's and
    the conv's alone, and the least time by operations and bytes; then
    pass 2's ICP polish at the same rows (:func:`polish_parity`). Returns
    the volume's and the polish search's entries, each by beam count."""
    from laser_slam_tpu_torch.core import scan as S
    from laser_slam_tpu_torch.ops import correlative, icp_points
    from laser_slam_tpu_torch.ops import preprocess as pp
    from laser_slam_tpu_torch.ops.cuda import correlative_kernel as V

    dev = torch.device("cuda")
    rows, k_rot = 128, 72
    n_steps = int(1.2 / correlative.GRID_RES)
    t = 2 * n_steps + 1
    thetas = correlative._linspace(-np.pi, np.pi, k_rot, torch.float32, dev).expand(rows, k_rot)
    base = torch.zeros(rows, 2, device=dev)
    rng = np.random.default_rng(13)
    out, search = {}, {}
    for model in (log.model, S.LMS511):
        if model.n_beams == log.model.n_beams:
            a, b = pairs(S.Scan(*(x[:rows + 1] for x in scans)), S)
        else:
            r = synth.ray_cast(synth.floor_plan(), synth.trajectory(rows + 1)[0],
                               model.bearings(torch.float64).numpy())
            r = np.where(r <= synth.MAX_RANGE, r + rng.normal(0.0, synth.NOISE, r.shape), r)
            a, b = pairs(pp.preprocess(torch.as_tensor(r.astype(np.float32), device=dev), model),
                         S)
        grid = correlative.build_likelihood_grid(model, a)
        pts, ok = icp_points.scan_to_points(model, b)
        args = dict(grid=grid, pts=pts, ok=ok, thetas=thetas.contiguous(), n_steps=n_steps,
                    res=correlative.GRID_RES, half_extent=correlative.GRID_HALF_EXTENT,
                    base_xy=base, overlap_norm=False, overlap_radius=1.5)
        volume_parity(args, f"pass 2, {model.name} ({model.n_beams} beams)")
        g = grid.shape[-1]
        ix, iy, inb = correlative._rotated_cells(pts, ok, args["thetas"], base,
                                                 correlative.GRID_RES,
                                                 correlative.GRID_HALF_EXTENT, g)
        cells = torch.where(inb, iy * g + ix, -1).to(torch.int32)
        planes = grid[None]
        plane = torch.arange(rows * k_rot, device=dev).view(rows, k_rot, 1) * (g * g)
        raster = torch.zeros(rows * k_rot * g * g, device=dev).index_add_(
            0, torch.where(inb, plane + iy * g + ix, 0).reshape(-1),
            inb.float().reshape(-1)).view(rows * k_rot, 1, g, g)
        pad = torch.nn.functional.pad(planes, (n_steps,) * 4)
        ms = cuda_ms(lambda: V.score_volume_sparse(planes, cells, n_steps), 50)
        plain_ms = cuda_ms(lambda: correlative._score_volume_conv(planes, ix, iy, inb, n_steps), 3)
        conv_ms = cuda_ms(lambda: correlative._conv2d(pad, raster, rows), 3)
        # A multiply-add (2 operations) a point on the raster, rotation and
        # shift; each grid, id and volume element once.
        madds = int(inb.sum()) * t * t
        t_ops = 2 * madds / PEAK_FP32_FLOPS * 1e3
        t_bytes = n_bytes(planes, cells) + rows * k_rot * t * t * 4
        t_bytes = t_bytes / PEAK_BYTES_S * 1e3
        bound, by = max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"
        phase("correlative", f"pass 2, {model.name}: kernel {ms:.4f} ms, plain version (raster, "
                             f"pad, conv) {plain_ms:.3f} ms, conv alone {conv_ms:.3f} ms, bound "
                             f"{bound:.4f} ms by {by} ({madds:.3g} multiply-adds); {smi}")
        out[model.n_beams] = {"ms": ms, "plain_ms": plain_ms, "library_ms": conv_ms,
                              "bound_ms": bound, "bound_by": by}
        search[model.n_beams] = polish_parity(model, a, pts, ok, smi)
    return out, search


def polish_parity(model, a, pts, ok, smi) -> dict:
    """Pass 2's ICP polish on the card (``match_correlative``'s
    ``match_icp_points``: 15 iterations, the gate from 3 cells) of the
    rows' points ``pts``/``ok`` onto their reference scans ``a`` from the
    zero pose, with the nearest-two kernel against the same polish with
    the plain block in its place, bit for bit; and the first iteration's
    search alone, kernel against plain block, both timed. Returns the
    search's entry at this shape."""
    from laser_slam_tpu_torch.ops import correlative, icp_points

    ref_pts, ref_ok = icp_points.scan_to_points(model, a)
    init = torch.zeros(pts.shape[0], 3, device=pts.device)

    def polish():
        return icp_points.match_icp_points(ref_pts, ref_ok, pts, ok, init, iters=15,
                                           max_corr=3.0 * correlative.GRID_RES)

    kernel_search = icp_points._nearest_two
    got = polish()
    icp_points._nearest_two = icp_points._nearest_two_plain
    try:
        want = polish()
    finally:
        icp_points._nearest_two = kernel_search
    q = pts.contiguous()
    search = (icp_points._nearest_two(q, ref_pts, ref_ok),
              icp_points._nearest_two_plain(q, ref_pts, ref_ok))
    equal = (all(g is w is None or torch.equal(g, w) for g, w in zip(got, want))
             and all(torch.equal(g, w) for g, w in zip(*search)))
    ms = cuda_ms(lambda: icp_points._nearest_two(q, ref_pts, ref_ok), 50)
    plain_ms = cuda_ms(lambda: icp_points._nearest_two_plain(q, ref_pts, ref_ok), 20)
    label = f"pass 2's polish, {model.name} ({pts.shape[0]} x {pts.shape[1]} points)"
    phase("correlative", f"{label}: nearest-two kernel against the plain block, 15 iterations "
                         f"and one search equal {equal}; one search {ms:.4f} ms, plain block "
                         f"{plain_ms:.4f} ms; {smi}")
    if not equal:
        raise AssertionError(f"{label}: the nearest-two kernel is not the plain search")
    return {"equal": equal, "ms": ms, "plain_ms": plain_ms}


def slam_phase(cli, K, log_path, log, smi):
    """Drives ``cli slam`` on ``cuda`` at ``SlamConfig()`` defaults, holds
    the result (see the module docstring), prints the ``[slam]``
    lines and the trace of one wave. Returns K1's chain-entry launches
    the run's diagnostics (the loop bank, the anchor poses) and the sparse
    score-volume kernel's launches."""
    from laser_slam_tpu_torch.eval.diagnostics import classify_loops
    from laser_slam_tpu_torch.graph import solve
    from laser_slam_tpu_torch.graph.submap import build_submaps
    from laser_slam_tpu_torch.runtime import slam

    cfg = slam.SlamConfig()
    waves = cfg.rounds + cfg.cov_rounds
    # Every LM iteration solves the normal equations once and then reads its
    # accept flags on the host: the calls count the solver's device syncs.
    solve_normal, lm_iterations = solve._solve_normal, [0]

    def counting(g, lam, **kw):
        lm_iterations[0] += 1
        return solve_normal(g, lam, **kw)

    K.match_psm_fused.launches = K.odometry_chain_fused.launches = 0
    torch.cuda.reset_peak_memory_stats()
    solve._solve_normal = counting
    volumes = {}
    try:
        with volume_calls(volumes) as calls:
            run = cli.main(["slam", log_path, "--device", "cuda"])
    finally:
        solve._solve_normal = solve_normal
    torch.cuda.synchronize()
    volume_launches = check_volume_launches(calls, "cli slam")
    launches = (K.odometry_chain_fused.launches, K.match_psm_fused.launches)
    res, tm, bank = run.result, run.diag["timing"], run.diag["bank"]
    t = log.n_scans
    if any(x.device.type != "cuda" for x in res):
        raise AssertionError("a tensor of the SLAM result is not on cuda")
    poses = res.poses.cpu().numpy()
    if poses.shape != (t, 3) or not np.isfinite(poses).all():
        raise AssertionError(f"bad SLAM trajectory: shape {poses.shape}")
    if launches != (1, 0):
        raise AssertionError(f"slam launched K1's chain entry {launches[0]} times (expected "
                             f"once) and its batch entry {launches[1]} times")
    if any(len(tm[k]) != waves for k in ("propose", "verify", "solve")):
        raise AssertionError(f"not all {waves} waves ran: {tm}")
    strict = bank["act"] & bank["strict"]
    used = bank["used"]
    if not (strict.sum() >= 1 and (used & strict).sum() >= 1 and int(res.n_loops) == used.sum()):
        raise AssertionError(f"no strict loop banked and used: banked {int(bank['act'].sum())}, "
                             f"strict {int(strict.sum())}, used {int(used.sum())}")
    ate_odo, ate_slam = float(run.ate_odo.rmse), float(run.ate.rmse)
    gt_anchor = log.gt_pose[res.anchor_idx.cpu().numpy()]
    rep = classify_loops(bank["src"], bank["dst"], bank["rel"], used, gt_anchor)
    wrong = 1.0 - rep.n_correct / max(rep.n, 1)
    verify_s = float(np.sum(tm["verify"]))
    phase("slam", f"{t} scans, {gt_anchor.shape[0]} anchors, {waves} waves of "
                  f"{cfg.max_loops} candidates in chunks of {cfg.verify_chunk}: slam_offline "
                  f"{run.seconds:.3f}s; peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    phase("slam", "stage seconds " + json.dumps({
        k: ([round(x, 4) for x in v] if isinstance(v, list) else round(v, 4))
        for k, v in tm.items()}))
    phase("slam", f"verify {waves * cfg.max_loops / verify_s:.1f} pairs/s "
                  f"({verify_s:.3f}s for {waves * cfg.max_loops} pairs); loops banked "
                  f"{int(bank['act'].sum())} / strict {int(strict.sum())} / used "
                  f"{int(used.sum())}; ATE odometry {ate_odo:.4f} m -> SLAM {ate_slam:.4f} m; "
                  f"used loops wrong (> 0.5 m or 0.2 rad from the ground truth) "
                  f"{rep.n - rep.n_correct} of {rep.n} = {wrong:.4f}; chi2 {float(res.chi2):.3f}; "
                  f"LM iterations (one host sync each) {lm_iterations[0]} in {2 * waves} solves")
    if not ate_slam < ate_odo:
        raise AssertionError(f"SLAM ATE {ate_slam} is not below the odometry ATE {ate_odo}")
    phase("correlative", f"cli slam: {calls[0]} score volumes, sparse kernel launches "
                         f"{volume_launches}")
    if {k[0] for k in volumes if not k[1]} != {False, True}:
        raise AssertionError(f"cli slam made no batched score volume of one of loop closure's "
                             f"two lanes: {sorted(volumes)}")
    for (lane, _, g), a in sorted(volumes.items()):
        volume_parity(a, f"cli slam, first volume with overlap_norm={lane} on a {g}^2 grid")

    # One wave (the first: from the odometry estimate, an empty bank) under
    # the profiler, with the signature gate and the wide clouds before it.
    dev = torch.device("cuda")
    ranges = torch.as_tensor(log.ranges, device=dev)
    (scans, odo_poses, _, _, anchor_poses, rel_seq, seq_weight, block_id) = slam._frontend(
        log.model, cfg, ranges, log.timestamps)
    submaps = build_submaps(log.model, scans, odo_poses, cfg.anchor_stride, cfg.submap_points)
    one_wave = dataclasses.replace(cfg, rounds=1, cov_rounds=0)
    host_ops = {}
    wall, n_ops, busy, _ = trace(lambda: slam.run_correlative_rounds(
        one_wave, submaps, anchor_poses, rel_seq, seq_weight, block_id=block_id), host_ops)
    phase("trace", "one slam wave: " + json.dumps({
        "traced_wall_s": wall, "device_ops": n_ops, "device_busy_s": busy,
        "idle_share_of_traced_wall": 1.0 - busy / wall,
        "hot_spots_device_s": {k: {"what": HOT_SPOTS[k], "calls": host_ops.get(k, (0, 0.0))[0],
                                   "seconds": host_ops.get(k, (0, 0.0))[1]} for k in HOT_SPOTS},
        "aten_ops_device_s": {k: {"calls": v[0], "seconds": v[1]}
                              for k, v in host_ops.items() if k not in HOT_SPOTS},
        "card": smi}))
    if n_ops == 0 or host_ops.get("h1_nearest_two", (0, 0.0))[0] == 0:
        raise AssertionError("the traced wave ran no device operation of the verifier")
    return launches[0], run.diag, volume_launches



def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the host clock over ``reps`` runs
    after a warm-up, the device synchronised at both ends: what a caller
    waits for a call that is bound by the host's issue rate."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def percentiles(x) -> dict:
    x = np.asarray(x, np.float64) * 1e3
    if x.size == 0:
        return {"n": 0}
    return {"n": int(x.size), "p50_ms": float(np.percentile(x, 50)),
            "p99_ms": float(np.percentile(x, 99)), "max_ms": float(x.max())}


def drive_facade(log, n_scans, async_backend, K, odometry, record=None, period=0.0):
    """Feeds the log's first ``n_scans`` scans through ``SlamV1`` in its
    mapping mode on ``cuda`` (the default device) with a local-map, an
    obstacle and a frontend-pose callback, one scan every ``period``
    seconds (0: as fast as they are taken; the waiting is not part of a
    call's seconds). Returns the facade, each call's
    seconds, whether a backend round was in flight when the call began,
    every round's wall, the frontend's poses as they came, the callbacks'
    counts and K1's batch-entry launches. With a list ``record``, every
    ``STEP_SAMPLE``-th K1 call's inputs are kept in it."""
    from laser_slam_tpu_torch.runtime import facade, online

    counts = {"local_map": 0, "obstacle": 0, "deep_fallback": 0}
    front = []

    def on_local_map(win):
        counts["local_map"] += 1
        counts["local_map_shape"] = win.shape

    def on_obstacle(speed, zone):
        counts["obstacle"] += 1

    s = facade.SlamV1(log.model, callbacks=facade.SlamCallbacks(
        on_local_map=on_local_map, on_obstacle=on_obstacle,
        on_slam_pose=lambda p: front.append(np.array(p))), async_backend=async_backend)
    s.start()
    slam = s._slam
    if slam.device.type != "cuda":
        raise AssertionError(f"SlamV1 runs on {slam.device} by default")
    walls, plain_round = [], slam._backend.round

    def timed_round(*snap):
        out = plain_round(*snap)
        if out is not None:
            walls.append(slam._backend._last_round_wall)
        return out

    slam._backend.round = timed_round
    fused, calls = K.match_psm_fused, [0]

    def recording(model, ref, cur, init_pose=None, error_ref=None):
        calls[0] += 1
        if record is not None and calls[0] % STEP_SAMPLE == 0:
            record.append((ref, cur, init_pose, error_ref))
        return fused(model, ref, cur, init_pose, error_ref)

    step_deep = online._step_deep

    def counting_deep(*args):
        counts["deep_fallback"] += 1
        return step_deep(*args)

    odometry.match_psm_fused, online._step_deep = recording, counting_deep
    K.match_psm_fused.launches = K.odometry_chain_fused.launches = 0
    seconds, in_flight = [], []
    try:
        for r in log.ranges[:n_scans]:
            in_flight.append(slam._bg_thread is not None and slam._bg_thread.is_alive())
            t0 = time.perf_counter()
            s.feed_scan_main(r)
            seconds.append(time.perf_counter() - t0)
            time.sleep(max(0.0, period - seconds[-1]))
    finally:
        odometry.match_psm_fused, online._step_deep = fused, step_deep
    launches = (K.match_psm_fused.launches, K.odometry_chain_fused.launches)
    if launches != (n_scans - 1, 0) or calls[0] != n_scans - 1:
        raise AssertionError(f"{n_scans} scans launched K1's batch entry {launches[0]} times "
                             f"({calls[0]} calls) and its chain entry {launches[1]} times")
    if counts["local_map"] != n_scans or counts["obstacle"] != n_scans:
        raise AssertionError(f"callbacks fired {counts} times for {n_scans} scans")
    return s, np.asarray(seconds), np.asarray(in_flight), walls, np.stack(front), counts, launches[0]


def online_phase(K, log, smi, stats, psm, odometry, tmp_dir):
    """The online path (see the module docstring, phase 6). Returns K1's
    batch-entry launches of the shipped (async) session, the sparse
    score-volume kernel's, and the largest difference of its B = 1 volume
    from the conv's (None without a deep frontend step)."""
    from laser_slam_tpu_torch.eval import metrics
    from laser_slam_tpu_torch.eval.diagnostics import classify_loops
    from laser_slam_tpu_torch.runtime.online import OnlineSlam

    model, t = log.model, log.n_scans
    dev = torch.device("cuda")
    gt = torch.as_tensor(log.gt_pose, dtype=torch.float32, device=dev)

    def ate_of(poses):
        p = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=dev)
        return float(metrics.ate(p, gt[: p.shape[0]]).rmse)

    # -- the session as shipped: async backend, the filter, the live map --
    torch.cuda.reset_peak_memory_stats()
    inputs = []
    volumes = {}
    with volume_calls(volumes) as calls:
        t0 = time.perf_counter()
        s, sec, busy, walls, front_async, counts, launches = drive_facade(
            log, t, True, K, odometry, record=inputs, period=REPLAY_PERIOD)
        feed_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        s.stop()
        stop_s = time.perf_counter() - t0
    volume_launches = check_volume_launches(calls, "the async session")
    slam = s._slam
    ate_drained = ate_of(slam.trajectory)
    stats_before_final = dict(slam.async_stats)
    t0 = time.perf_counter()
    slam.flush(final_round=True)
    final_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if s.feed_scan_main(log.ranges[0]) is not None:
        raise AssertionError("the stopped facade still takes scans")
    bank = slam._backend._bank
    strict = int((bank["act"] & bank["strict"]).sum())
    ate_odo, ate_flushed = ate_of(np.stack(slam._odo_chain)), ate_of(slam.trajectory)
    gt_anchor = log.gt_pose[np.arange(len(slam._backend._group_pts)) * slam.cfg.anchor_stride]
    rep = classify_loops(bank["src"], bank["dst"], bank["rel"], bank["used"], gt_anchor)
    st = slam.async_stats
    phase("online", f"SlamV1 mapping, async backend, {t} scans, {len(slam._scans)} anchors, one "
                    f"scan every {REPLAY_PERIOD * 1e3:.0f} ms: fed in {feed_s:.2f}s, of it "
                    f"{float(sec.sum()):.2f}s inside feed_scan_main; stop() drained in {stop_s:.2f}s, "
                    f"final round {final_s:.2f}s; K1 batch-entry launches {launches} (one a scan); "
                    f"callbacks {counts}; peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    phase("online", "per-scan latency of feed_scan_main " + json.dumps({
        "all": percentiles(sec[1:]), "no_round_in_flight": percentiles(sec[1:][~busy[1:]]),
        "round_in_flight": percentiles(sec[1:][busy[1:]]), "first_scan_ms": float(sec[0] * 1e3),
        "card": smi}))
    phase("online", f"async_stats {json.dumps(st)} (before the final round "
                    f"{json.dumps(stats_before_final)}); round walls s "
                    f"{[round(w, 3) for w in walls]}; loops banked {int(bank['act'].sum())} / "
                    f"strict {strict} / used by the last solve {slam.n_loops}, of them wrong (> 0.5 m or "
                    f"0.2 rad from the ground truth) {rep.n - rep.n_correct}; weak steps "
                    f"{sum(slam._weak)}, fractures {sum(slam._fracture)}; ATE odometry chain "
                    f"{ate_odo:.4f} m -> drained {ate_drained:.4f} m -> flushed {ate_flushed:.4f} m")
    if not (st["started"] >= 2 and st["applied"] >= 1
            and st["requested"] - st["coalesced"] <= st["started"] <= st["requested"]
            and st["overlap_scans_max"] >= 1):
        raise AssertionError(f"the async scheduler's counters are off: {st}")
    if slam._bg_result is not None or slam._pending_round or slam._bg_thread.is_alive():
        raise AssertionError("a round is left in flight or pending after flush")
    if strict < 1 or not np.isfinite(slam.trajectory).all() or slam.trajectory.shape != (t, 3):
        raise AssertionError(f"online session: {strict} strict loops, trajectory "
                             f"{slam.trajectory.shape}")
    if not ate_flushed < ate_odo:
        raise AssertionError(f"flushed ATE {ate_flushed} is not below the odometry ATE {ate_odo}")
    phase("correlative", f"async session: {calls[0]} score volumes ({counts['deep_fallback']} "
                         f"deep frontend steps, B = 1), sparse kernel launches {volume_launches}")
    b1 = []
    for (lane, one, g), a in sorted(volumes.items()):
        label = f"async session, first volume with overlap_norm={lane} on a {g}^2 grid"
        if one:
            b1.append(volume_parity(a, f"{label}, B = 1 (the frontend's deep step)", exact=False))
        else:
            volume_parity(a, label)
    grid = s.global_map(slam.map_resolution)
    if grid.log_odds.device.type != "cuda" or int((grid.log_odds > 0).sum()) < 1000:
        raise AssertionError("the live map is empty or not on cuda")

    # -- K1 on this path: every STEP_SAMPLE-th scan's own two-pair inputs --
    sample = [c for c in inputs if bool(c[2][0].abs().sum() > 0)]
    if len(sample) < (t - 1) // STEP_SAMPLE // 2:
        raise AssertionError(f"only {len(sample)} sampled scans have a nonzero prior")
    got = [K.match_psm_fused(model, *c) for c in sample]
    label = f"{model.name} {len(sample)} online scans x2 pairs, nonzero prior, plain on cuda"
    stats.append(parity(cat_results([g[0] for g in got], psm),
                        cat_results([psm.match_psm(model, *c[:3]) for c in sample], psm), label))
    stats[-1]["index_rel_err"] = index_parity(
        [torch.cat(x) for x in zip(*(g[1] for g in got))],
        [torch.cat(x) for x in zip(*(psm.error_index(model, c[3], c[1], g[0].pose)
                                     for c, g in zip(sample, got)))], label)

    # -- the synchronous backend on the first 1000 scans --------------------
    n_sync = min(1000, t)
    t0 = time.perf_counter()
    s2, sec2, _, walls2, front_sync, _, _ = drive_facade(log, n_sync, False, K, odometry)
    sync_s = time.perf_counter() - t0
    sync = s2._slam
    quiet = sec2[1:][sec2[1:] < 0.25]
    phase("online", f"sync backend, {n_sync} scans in {sync_s:.2f}s: {len(walls2)} rounds inside "
                    f"feed_scan, walls s {[round(w, 3) for w in walls2]}; scans without a round "
                    + json.dumps(percentiles(quiet)) + f"; ATE odometry chain "
                    f"{ate_of(np.stack(sync._odo_chain)):.4f} m -> {ate_of(sync.trajectory):.4f} m")
    # The first round is asked for when the 10th anchor arrives (scan 90):
    # until then no correction has reached either frontend, and the two
    # run the same launches on the same inputs.
    first_round = (sync.optimize_every - 1) * sync.cfg.anchor_stride
    front_err = float(np.abs(front_async[: first_round - 1] - front_sync[: first_round - 1]).max())
    phase("online", f"async vs sync frontend poses before the first round (scans 1..{first_round - 1}"
                    f"): max |dpose| {front_err:.3g}")
    if not front_err <= 1e-6:
        raise AssertionError(f"the two frontends differ by {front_err} before any round applied")

    # -- checkpoint: save at scan 1000, resume, 200 more on both ------------
    # A checkpoint holds the per-scan records and the frontend's carry; the
    # resumed session starts with an empty loop bank, as the original's
    # does. So both sessions go on with the backend idle, and what is held
    # is the frontend: the same poses, to 1e-5.
    path = os.path.join(tmp_dir, "session.npz")
    sync.save(path)
    idle = 10 ** 9
    resumed = OnlineSlam.resume(model, path, use_fusion=True, optimize_every=idle)
    sync.optimize_every = idle
    more = log.ranges[n_sync:n_sync + 200]
    for r in more:
        sync.feed_scan(r)
        resumed.feed_scan(r)
    ck_err = float(np.abs(sync.trajectory - resumed.trajectory).max())
    phase("checkpoint", f"saved at scan {n_sync} ({os.path.getsize(path) / 2**20:.2f} MiB), "
                        f"resumed on {resumed.device}, {len(more)} more scans: max |dpose| against "
                        f"the uninterrupted session {ck_err:.3g} over {len(resumed._poses)} scans")
    if resumed.device.type != "cuda" or len(resumed._poses) != n_sync + len(more) \
            or not ck_err <= 1e-5:
        raise AssertionError(f"the resumed session differs by {ck_err}")

    # -- the device's view of a scan: 200 calls with no round in flight ------
    n_tr = 200
    rest = log.ranges[n_sync + 200:n_sync + 200 + n_tr]

    def feed_rest():
        for r in rest:
            s2.feed_scan_main(r)

    wall, n_ops, busy_s, by_name = trace(feed_rest)
    k1_n, k1_s = by_name.get("psm_match_kernel", (0, 0.0))
    phase("trace", f"online, {n_tr} feed_scan_main calls, no round in flight: " + json.dumps({
        "traced_wall_s": wall, "traced_ms_per_scan": wall / n_tr * 1e3,
        "device_ops_per_scan": n_ops / n_tr, "device_busy_s": busy_s,
        "device_busy_share_of_traced_wall": busy_s / wall,
        "k1_launches": k1_n, "k1_device_ms_per_scan": k1_s / max(k1_n, 1) * 1e3, "card": smi}))
    if k1_n != n_tr or "psm_chain_kernel" in by_name:
        raise AssertionError(f"{n_tr} scans show {k1_n} psm_match_kernel launches in the trace")

    # -- each layer of a scan, alone (host clock, synchronised) -------------
    from laser_slam_tpu_torch.fusion import ukf
    from laser_slam_tpu_torch.ops import preprocess as pp

    r0 = np.asarray(log.ranges[n_sync], np.float32)
    scan = pp.preprocess(torch.as_tensor(r0, device=dev), model)
    carry = sync._carry
    pose = sync._poses[-1]
    inp = ukf.FusionInputs(torch.zeros(3, device=dev), sync._true, torch.zeros(3, device=dev),
                           sync._true, *sync._no_beacon, slam_t=torch.ones((), device=dev))
    layers = {
        "upload_and_preprocess_ms": host_ms(
            lambda: pp.preprocess(torch.as_tensor(r0).to(dev), model), 100),
        "step_k1_and_selects_ms": host_ms(lambda: odometry._step_flagged(model, carry, scan), 100),
        "step_fetch_ms": host_ms(lambda: carry.last_gpose.cpu(), 100),
        "map_add_ms": host_ms(lambda: sync._imap.add(scan, pose), 50),
        "fusion_step_ms": host_ms(lambda: ukf.fusion_step(sync._fusion, inp), 100),
        "fused_pose_fetch_ms": host_ms(lambda: sync.pose, 100),
        "local_map_ms": host_ms(lambda: torch.sigmoid(sync.local_map(pose, 50)[0]).cpu(), 100),
        "obstacle_check_ms": host_ms(lambda: s2._obstacle_check(r0), 100),
        "deep_fallback_ms": host_ms(
            lambda: odometry._step_deep(model, carry, scan, torch.zeros(3, device=dev)), 10),
    }
    n_hist = len(sync._imap._scans)
    grids = []
    for _ in range(2):
        t0 = time.perf_counter()
        sync._imap.rebase(np.stack(sync._poses)[:n_hist])
        torch.cuda.synchronize()
        layers["map_rebase_s"], layers["map_rebase_scans"] = time.perf_counter() - t0, n_hist
        grids.append(sync._imap.grid.log_odds)
    # index_add_ sums with float atomics: the same scans at the same poses
    # twice give the same grid only up to the order of the sums.
    layers["map_twice_max_abs_diff"] = float((grids[0] - grids[1]).abs().max())
    layers["map_twice_cells_differing"] = int((grids[0] != grids[1]).sum())
    layers["card"] = smi
    phase("layers", "online scan " + json.dumps(layers))
    return launches, volume_launches, max(b1, default=None)


def localize_phase(cli, log_path, log, smi):
    """Localization on the card (see the module docstring, phase 7)."""
    from laser_slam_tpu_torch.core import se2
    from laser_slam_tpu_torch.localization import particle_filter as pf
    from laser_slam_tpu_torch.localization import raycast
    from laser_slam_tpu_torch.mapping import occupancy as occ
    from laser_slam_tpu_torch.ops import preprocess as pp
    from laser_slam_tpu_torch.ops.cuda import raycast_kernel as RK

    dev = torch.device("cuda")
    n_particles, ticks = 4096, 200
    run = cli.main(["localize", log_path, "--particles", str(n_particles), "--steps", str(ticks)])
    torch.cuda.synchronize()
    mean, p90 = float(run.errors.mean()), float(np.percentile(run.errors, 90))
    if run.state.poses.device.type != "cuda" or run.errors.shape != (ticks,):
        raise AssertionError("cli localize did not run 200 ticks on cuda")
    if not (np.isfinite(run.errors).all() and mean < 0.25 and p90 < 0.5):
        raise AssertionError(f"cli localize lost the robot: mean {mean} m, p90 {p90} m")
    model, grid = log.model, run.grid
    spec = grid.spec
    phase("localize", f"cli localize, {n_particles} particles, {ticks} ticks on a "
                      f"{spec.width}x{spec.height} grid at {spec.resolution} m: pos err mean "
                      f"{mean:.4f} m p90 {p90:.4f} m; the ticks took {run.seconds:.3f}s")

    # The beam model's entry point: one ray-march launch a tick.
    beam_ticks = 50
    RK.ray_march.launches = 0
    run_b = cli.main(["localize", log_path, "--particles", str(n_particles), "--steps",
                      str(beam_ticks), "--resolution", "0.02", "--model", "beam"])
    torch.cuda.synchronize()
    cli_launches = RK.ray_march.launches
    mean_b = float(run_b.errors.mean())
    phase("localize", f"cli localize --model beam, {n_particles} particles, {beam_ticks} ticks "
                      f"at 0.02 m: pos err mean {mean_b:.4f} m; the ticks took "
                      f"{run_b.seconds:.3f}s; ray-march launches {cli_launches}")
    if run_b.errors.shape != (beam_ticks,) or not (np.isfinite(run_b.errors).all()
                                                    and mean_b < 0.25):
        raise AssertionError(f"cli localize --model beam lost the robot: mean {mean_b} m")
    if cli_launches != beam_ticks:
        raise AssertionError(f"cli localize --model beam launched the ray march {cli_launches} "
                             f"times in {beam_ticks} ticks, not once a tick")

    scans = pp.preprocess(torch.as_tensor(log.ranges, device=dev), model)
    gt = torch.as_tensor(log.gt_pose, dtype=torch.float32, device=dev)
    split = log.n_scans // 2
    field_ms = cuda_ms(lambda: raycast.likelihood_field(grid), 3)
    field = raycast.likelihood_field(grid)
    n_iter = int(3.0 * 0.2 / spec.resolution) + 1

    def valid_at(i):
        return ~scans.bad[i] & (scans.ranges[i] < model.max_range)

    # Global relocalization from 10,000 uniform samples, as the facade's
    # localization mode starts: the kept samples are ranked, in free space.
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    reloc, reloc_s = host_s(lambda: pf.global_relocalize(
        gen, grid, field, model, scans.ranges[split], valid_at(split), n_samples=10_000))
    best = reloc.poses[0].cpu().numpy()
    cells = spec.world_to_cell(reloc.poses[:, :2])
    if reloc.poses.shape != (1024, 3) or not bool((reloc.log_w[:-1] >= reloc.log_w[1:]).all()) \
            or not bool(spec.contains(cells).all()):
        raise AssertionError("global_relocalize: bad cloud")
    phase("localize", f"likelihood_field ({n_iter} min-plus passes over {spec.width * spec.height} "
                      f"cells) {field_ms:.3f} ms; global_relocalize 10000 samples -> 1024 in "
                      f"{reloc_s * 1e3:.2f} ms, best sample {[round(float(v), 2) for v in best]} for truth "
                      f"{[round(float(v), 2) for v in log.gt_pose[split]]}; {smi}")

    # 200 ticks at 4096 particles with distinct scans, by CUDA events.
    state0 = pf.init_gaussian(gen, gt[split], n_particles)
    rels = se2.relative(gt[split:split + ticks], gt[split + 1:split + ticks + 1])
    valids = torch.stack([valid_at(split + 1 + k) for k in range(ticks)])

    def run_ticks():
        st = state0
        for k in range(ticks):
            st = pf.predict(st, rels[k], gen, sigma_xy=0.05, sigma_theta=0.03)
            st = pf.update_field(st, field, grid, model, scans.ranges[split + 1 + k], valids[k])
            st = pf.maybe_resample(st, gen)
            est = pf.estimate(st)
        return st, est

    tick_ms = cuda_ms(run_ticks, 2) / ticks
    _, n_ops, busy_s, _ = trace(run_ticks)
    # One beam-model update at 4096 particles: the whole cloud in one
    # ray-march launch on the card.
    n_samples = int(model.max_range / spec.resolution)
    torch.cuda.reset_peak_memory_stats()
    RK.ray_march.launches = 0
    beam, beam_s = host_s(lambda: pf.update_beam(
        state0, grid, model, scans.ranges[split], valid_at(split)))
    beam_launches = RK.ray_march.launches
    if not bool(torch.isfinite(beam.log_w).all()):
        raise AssertionError("update_beam gave non-finite weights")
    if beam_launches != 1:
        raise AssertionError(f"update_beam launched the ray march {beam_launches} times, not once")
    phase("localize", json.dumps({
        "pf_tick_ms": tick_ms, "particle_updates_per_s": n_particles / tick_ms * 1e3,
        "device_ops_per_tick": n_ops / ticks, "device_busy_ms_per_tick": busy_s / ticks * 1e3,
        "likelihood_field_ms": field_ms, "update_beam_s": beam_s,
        "update_beam_launches": beam_launches, "samples_per_beam": n_samples,
        "update_beam_peak_GiB": torch.cuda.max_memory_allocated() / 2**30, "card": smi}))

    # The card against the same functions on the CPU with the same draws.
    noise_xy = torch.randn(n_particles, 2, generator=gen, device=dev)
    noise_t = torch.randn(n_particles, generator=gen, device=dev)
    u = float(torch.rand((), generator=gen, device=dev))
    obs, ok = scans.ranges[split + 1], valid_at(split + 1)

    def tick(st, to):
        st = pf.predict_with_noise(st, rels[0].to(to), noise_xy.to(to), noise_t.to(to), 0.05, 0.03)
        g = occ.OccupancyGrid(grid.log_odds.to(to), spec)
        st = pf.update_field(st, raycast.likelihood_field(g), g, model, obs.to(to), ok.to(to))
        return st, pf.maybe_resample_at(st, u)

    card, card_rs = tick(state0, dev)
    host, host_rs = tick(pf.ParticleState(*(x.cpu() for x in state0)), "cpu")
    d = (card.log_w.cpu() - host.log_w).abs().numpy()
    # The same estimate from the same cloud on either device; the clouds
    # themselves differ where an endpoint on a cell edge reads the
    # neighbouring cell (last bits of cos/sin), and a resampled index at a
    # boundary of the cumulative sum.
    est_err = float((pf.estimate(card).cpu() - pf.estimate(
        pf.ParticleState(card.poses.cpu(), card.log_w.cpu()))).abs().max())
    moved = float((card_rs.poses.cpu() != host_rs.poses).any(dim=1).float().mean())
    phase("localize", f"card vs cpu, one tick with the same draws: log-weights max |d| "
                      f"{d.max():.3g}, share above 1e-4 {float((d > 1e-4).mean()):.4f}; estimate "
                      f"of the card's cloud on either device |d| {est_err:.3g}; resampled rows "
                      f"that differ {moved:.4f}")
    if not ((d > 1e-4).mean() <= 0.05 and d.max() < 0.1 and est_err <= 1e-3 and moved <= 0.05):
        raise AssertionError("the card's particle-filter tick disagrees with the CPU's")
    return {**march_phase(smi), "launches_localize_cli": cli_launches,
            "launches_update_beam": beam_launches}


def march_phase(smi) -> dict:
    """The beam model's ray-march kernel at one tick of the beam-model
    cell's shape (``tools/beam_cell.py``: 4096 poses x 361 beams on a 2 cm
    map, 2500 samples a beam): its ranges against the dense ladder's,
    bit for bit; both timed with CUDA events beside the least time by the
    benchmark's arithmetic (``benchmark/roofline_raycast.py``); the
    kernel's launches in this check (the timing's are not counted).
    Returns the kernel's JSON entry."""
    import beam_cell as cell
    from benchmark import roofline, roofline_raycast
    from laser_slam_tpu_torch.localization import raycast
    from laser_slam_tpu_torch.ops.cuda import raycast_kernel as RK

    grid, model, cloud, ranges, _ = cell.beam_cell()
    spec = grid.spec
    before = RK.ray_march.launches
    got = raycast.simulate_scan(grid, model, cloud)
    want = cell.ladder_in_chunks(grid, model, cloud)
    torch.cuda.synchronize()
    launches = RK.ray_march.launches - before
    equal = torch.equal(got, want)
    kernel_ms = cuda_ms(lambda: raycast.simulate_scan(grid, model, cloud), 20)
    plain_ms = cuda_ms(lambda: cell.ladder_in_chunks(grid, model, cloud), 2)
    need = int(roofline_raycast.samples_per_scan(ranges.cpu().numpy()[None], model.min_range,
                                                 model.max_range, spec.resolution)[0])
    n = cloud.shape[0]
    bound_s, bound_by = roofline.least_seconds(
        roofline_raycast.march_ops(n * need),
        roofline_raycast.tick_bytes(spec.width * spec.height, n, model.n_beams))
    entry = {
        "name": "ray_march_kernel (beam-model ray march: 4096 poses x 361 beams, 2500 samples "
                "a beam, on a 2 cm map of 5.7 k x 5.5 k cells)",
        "route": "cuda", "source": "laser_slam_tpu_torch/csrc/raycast_kernel.cu",
        "replaces": None, "launches_march_check": launches, "equal": equal,
        "max_abs_err": float((got - want).abs().max()), "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_s * 1e3, "bound_by": bound_by, "library_ms": None,
        "least_samples_per_pose": need, "hits": float((got < model.max_range).float().mean()),
        "samples_to_hit_mean": float((got[got < model.max_range] / spec.resolution).mean()),
    }
    phase("localize", "ray march at the beam cell's shape " + json.dumps({**entry, "card": smi}))
    if not equal or launches != 1:
        raise AssertionError(f"the ray march is not the ladder (equal {equal}) or did not launch "
                             f"once ({launches})")
    return entry


def nearest_two_phase(smi) -> dict:
    """The point-ICP nearest-two search kernel at the first iteration of
    one tick of the ray-cast + ICP cell's shape (``tools/beam_cell.py``'s
    map and cloud: 4096 particles, each one's 361 simulated points against
    the 361 observed points): ``j``, ``j2`` and ``nn_ok`` against the plain
    ``[b, N, N]`` block in chunks of 1024, bit for bit; both timed with
    CUDA events beside the least time of the search by the benchmark's
    arithmetic (``benchmark/roofline_icp.py``: 8 operations a pair of a
    valid observed point and a simulated point). Returns the kernel's JSON
    entry."""
    import beam_cell as cell
    import icp_search_cases as cases
    from benchmark import roofline, roofline_icp
    from laser_slam_tpu_torch.ops import icp_points
    from laser_slam_tpu_torch.ops.cuda import icp_nearest_kernel as NK

    grid, model, cloud, ranges, valid = cell.beam_cell()
    sim_pts, sim_ok, _, scan_ok, q = cases.cell_clouds(grid, model, cloud, ranges, valid)

    def plain():
        return [torch.cat(x) for x in zip(*(
            icp_points._nearest_two_plain(q[i:i + 1024], sim_pts[i:i + 1024], sim_ok[i:i + 1024])
            for i in range(0, q.shape[0], 1024)))]

    before = NK.nearest_two.launches
    got = icp_points._nearest_two(q, sim_pts, sim_ok)
    want = plain()
    torch.cuda.synchronize()
    launches = NK.nearest_two.launches - before
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    kernel_ms = cuda_ms(lambda: icp_points._nearest_two(q, sim_pts, sim_ok), 20)
    plain_ms = cuda_ms(plain, 3)
    n, points = q.shape[0], int(scan_ok[0].sum())
    bound_s, bound_by = roofline.least_seconds(
        n * points * model.n_beams * roofline_icp.OPS_PER_PAIR,
        n * model.n_beams * 2 * roofline_icp.POINT_BYTES)
    entry = {
        "name": "nearest_two_kernel (point-ICP nearest-two search: 4096 particles x 361 "
                "simulated points x 361 observed points, one ICP iteration)",
        "route": "cuda", "source": "laser_slam_tpu_torch/csrc/icp_nearest_kernel.cu",
        "replaces": None, "launches_search_check": launches, "equal": equal,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        "library_ms": None, "valid_observed_points": points,
        "simulated_hits": float(sim_ok.float().mean()),
    }
    phase("localize", "nearest-two search at the icp cell's shape " + json.dumps(
        {**entry, "card": smi}))
    if not equal or launches != 1:
        raise AssertionError(f"the nearest-two kernel is not the plain search (equal {equal}) or "
                             f"did not launch once ({launches})")
    return entry


def ate_of(poses, gt) -> float:
    """ATE rmse of ``poses [T, 3]`` (any array) against the first ``T``
    ground-truth poses, on the card."""
    from laser_slam_tpu_torch.eval import metrics

    p = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device="cuda")
    return float(metrics.ate(p, torch.as_tensor(gt[: p.shape[0]], dtype=torch.float32,
                                                device="cuda")).rmse)


def tcp_phase(cli, K, log_path, log, smi, tmp_dir):
    """The distributed topology (see the module docstring, phase 8): the
    server a process of its own, the client in this one. Returns K1's
    two-pair launches on the client."""
    from laser_slam_tpu_torch.eval.diagnostics import classify_loops
    from laser_slam_tpu_torch.runtime.slam import SlamConfig

    t = log.n_scans
    srv_traj, srv_diag, cli_traj = (os.path.join(tmp_dir, n) for n in ("server.txt", "server.npz",
                                                                      "client.txt"))
    server = subprocess.Popen(
        [sys.executable, "-m", "laser_slam_tpu_torch.cli", "serve", "--port", "0", "--device",
         "cuda", "--timeout", "300", "--out", srv_traj, "--diag", srv_diag],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        first = server.stdout.readline()
        if not first.startswith("listening on :"):
            raise AssertionError(f"cli serve did not start: {first!r}{server.stdout.read()}")
        port = int(first.split(":")[1].split()[0])
        K.match_psm_fused.launches = K.odometry_chain_fused.launches = 0
        t0 = time.perf_counter()
        run = cli.main(["client", log_path, "--port", str(port), "--device", "cuda",
                        "--out", cli_traj])
        client_s = time.perf_counter() - t0
        launches = (K.match_psm_fused.launches, K.odometry_chain_fused.launches)
        rest, _ = server.communicate(timeout=600)
        served_s = time.perf_counter() - t0
        if server.returncode != 0:
            raise AssertionError(f"cli serve failed ({server.returncode}):\n{rest}")
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    fe = run.frontend
    if launches != (t - 1, 0):
        raise AssertionError(f"the client launched K1's two-pair entry {launches[0]} times for "
                             f"{t - 1} steps, its chain entry {launches[1]} times")
    d = np.load(srv_diag)
    poses, walls = np.loadtxt(srv_traj), d["round_walls"]
    bank = {k[5:]: d[k] for k in d.files if k.startswith("bank_")}
    strict_used = bank["act"] & bank["strict"] & bank["used"]
    if poses.shape != (t, 3) or not np.isfinite(poses).all() or len(walls) < 2 \
            or strict_used.sum() < 1:
        raise AssertionError(f"server: trajectory {poses.shape}, {len(walls)} rounds, "
                             f"{int(strict_used.sum())} strict loops used")
    ate_odo, ate_srv = ate_of(fe.odometry, log.gt_pose), ate_of(poses, log.gt_pose)
    ate_client = ate_of(np.stack(fe.poses), log.gt_pose)
    # The server's anchors: every anchor_stride-th scan (SlamConfig()).
    rep = classify_loops(bank["src"], bank["dst"], bank["rel"], bank["used"],
                         log.gt_pose[::SlamConfig().anchor_stride])
    sec = run.seconds
    phase("tcp", f"cli serve (its own process) + cli client, {t} scans over localhost on cuda: "
                 f"client {client_s:.2f}s ({t / run.wall:.1f} scans/s), server done "
                 f"{served_s:.2f}s after the first scan; K1 two-pair launches on the client "
                 f"{launches[0]} (one a scan); {smi}")
    phase("tcp", "client per-scan latency " + json.dumps({
        "all": percentiles(sec[1:]), "first_scan_ms": float(sec[0] * 1e3),
        "pose_updates_applied": fe.n_updates, "weak": int(sum(fe.weak)),
        "fractures": int(sum(fe.fracture)), "card": smi}))
    phase("tcp", f"server: {len(walls)} rounds, walls s {[round(float(w), 3) for w in walls]}; "
                 f"loops banked {int(bank['act'].sum())} / strict {int((bank['act'] & bank['strict']).sum())}"
                 f" / used {int(bank['used'].sum())}, of the used wrong (> 0.5 m or 0.2 rad from the "
                 f"ground truth) {rep.n - rep.n_correct} = {(rep.n - rep.n_correct) / max(rep.n, 1):.4f}; "
                 f"wire bytes up {int(d['bytes_in'])} (client sent {fe.sock.bytes_sent}), down "
                 f"{int(d['bytes_out'])} in {int(d['n_updates'])} pose updates (client read "
                 f"{fe.sock.bytes_received}); ATE client raw odometry "
                 f"chain {ate_odo:.4f} m, client corrected {ate_client:.4f} m, server {ate_srv:.4f} m")
    # Updates the server sent after the client had finished streaming and
    # closed are counted by the server only.
    if int(d["bytes_in"]) != fe.sock.bytes_sent or int(d["bytes_out"]) < fe.sock.bytes_received:
        raise AssertionError("the two ends count different bytes on the wire")
    if not ate_srv < ate_odo:
        raise AssertionError(f"server ATE {ate_srv} is not below the odometry chain's {ate_odo}")
    return launches[0]


def matchers_phase(log, scans, smi):
    """Polar ICP and PL-ICP on the card (see the module docstring, phase 9)."""
    from laser_slam_tpu_torch.core import scan as S
    from laser_slam_tpu_torch.ops import icp, odometry, plicp

    model = log.model
    ref, cur = pairs(scans, S)
    n = ref.ranges.shape[0]
    out = {}
    for name, fn in (("match_icp", icp.match_icp), ("match_plicp", plicp.match_plicp)):
        info = {}
        fn(model, ref, cur)                          # warm-up: the allocator's first pass
        res, sec = host_s(lambda: fn(model, ref, cur, info=info))
        it = info["iters"].cpu().numpy()
        out[name] = {"pairs": n, "wall_s": sec, "pairs_per_s": n / sec, "iters_mean": float(it.mean()),
                     "iters_max": int(it.max()), "iters_total": int(it.sum()),
                     "fails": int(res.fail.sum())}
    for route, use_icp in (("odometry_pairwise_icp", True), ("odometry_pairwise_psm", False)):
        res, sec = host_s(lambda: odometry.odometry_pairwise(model, scans, use_icp=use_icp))
        out[route] = {"wall_s": sec, "ate_m": ate_of(res.poses.cpu(), log.gt_pose),
                      "failed_pairs": int(res.discarded.sum())}
    out["card"] = smi
    phase("matchers", json.dumps(out))

    # The card against the CPU on the first 300 pairs: the same bounds as
    # K1's (last bits of atan2 / cos differ between the devices and can
    # move a match by a few mm).
    a, b = pairs(S.Scan(*(x[:301] for x in scans)), S)
    for name, fn in (("match_icp", icp.match_icp), ("match_plicp", plicp.match_plicp)):
        cross_device_parity(fn(model, a, b), fn(model, a.to("cpu"), b.to("cpu")),
                            f"{name} {model.name} x300, cuda vs cpu")


def slam_icp_phase(log, smi):
    """The ICP-verified branch of ``slam_offline`` on the card (phase 10):
    its rounds from JAX's front end (the odometry in
    ``baselines/jax_synthetic_front.npz``), and ``slam_offline`` end to end
    from the port's own front end, each held to JAX's loops and ATE from
    the same front end. The branch amplifies its input: from the two front
    ends (odometry ATE 3.93 and 4.15 m) it keeps 53 and 1 loops."""
    from laser_slam_tpu_torch.graph.submap import build_submaps
    from laser_slam_tpu_torch.ops import odometry, preprocess as pp
    from laser_slam_tpu_torch.runtime import slam

    dev = torch.device("cuda")
    model = log.model
    scans = pp.preprocess(torch.as_tensor(log.ranges, device=dev), model)
    jax_front = np.load(ROOT / "baselines" / "jax_synthetic_front.npz")
    odo = odometry.odometry_keyframe(model, scans, timestamps=log.timestamps)
    card_front = {k: getattr(odo, k).cpu().numpy() for k in ("poses", "weak", "fracture")}
    os.makedirs(ROOT / "build", exist_ok=True)
    np.savez_compressed(ROOT / "build" / "slam_icp_card_front.npz", **card_front)
    # The card-front reference holds only for the front end it came from.
    kept = np.load(ROOT / "baselines" / "port_card_synthetic_front.npz")
    front_err = float(np.abs(card_front["poses"] - kept["poses"]).max())
    if not (front_err <= CARD_FRONT_ATOL and all(np.array_equal(card_front[k], kept[k])
                                                 for k in ("weak", "fracture"))):
        raise AssertionError(f"the card's keyframe odometry moved from "
                             f"baselines/port_card_synthetic_front.npz (max |dpose| {front_err}, "
                             f"or its flags): rerun tools/icp_branch_reference.py on it")

    def held(what, n_loops, ate, want):
        loops, ref = want
        phase("slam-icp", f"  {what}: loops kept {n_loops} (JAX {loops}), ATE {ate:.6f} m (JAX "
                          f"{ref:.6f}, |diff| {abs(ate - ref):.2e}, tolerance {SLAM_ICP_ATE_ATOL}; "
                          f"the bound 1.10 x JAX + 0.02 m is {ATE_FACTOR * ref + ATE_SLACK:.4f})")
        if n_loops != loops or not abs(ate - ref) <= SLAM_ICP_ATE_ATOL:
            raise AssertionError(f"ICP-branch SLAM {what}: {n_loops} loops and ATE {ate}, "
                                 f"JAX {loops} and {ref}")

    for use_submaps in (False, True):
        cfg = slam.SlamConfig(use_correlative=False, use_submaps=use_submaps)
        # The rounds from JAX's front end: its odometry on the card's scans.
        front = {k: torch.as_tensor(jax_front[k][: log.n_scans], device=dev)
                 for k in ("poses", "weak", "fracture")}
        timing = {}
        torch.cuda.reset_peak_memory_stats()
        (_, _, anchor_scans, anchor_poses, rel_seq, seq_w, _) = slam._frontend_post(
            cfg, scans, front["poses"], front["weak"], front["fracture"])
        submaps = (build_submaps(model, scans, front["poses"], cfg.anchor_stride, cfg.submap_points)
                   if use_submaps else None)
        (ap, n_loops, chi), sec = host_s(lambda: slam.run_icp_rounds(
            model, cfg, anchor_scans, anchor_poses, rel_seq, seq_w, submaps, timing=timing))
        ate = ate_of(slam._reattach(cfg, ap, front["poses"]).cpu(), log.gt_pose)
        ate_odo = ate_of(front["poses"].cpu(), log.gt_pose)
        phase("slam-icp", f"use_submaps={use_submaps}, from JAX's odometry: {cfg.rounds} rounds "
                          f"(radius {cfg.loop_radius} m doubling) of {cfg.max_loops} candidates over "
                          f"{anchor_poses.shape[0]} anchors in {sec:.3f}s, rounds s "
                          f"{[round(x, 3) for x in timing['rounds']]}; chi2 {float(chi):.4f}; ATE "
                          f"{ate_odo:.4f} m -> {ate:.4f} m; peak device memory "
                          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
        held("from JAX's odometry", int(n_loops), ate, JAX_SLAM_ICP[use_submaps])
        if not ate < JAX_FRONT_ODOMETRY_ATE:
            raise AssertionError(f"ICP-branch SLAM ATE {ate} from JAX's odometry is not below "
                                 f"that odometry's {JAX_FRONT_ODOMETRY_ATE}")

        # slam_offline end to end: the port's own front end on the card.
        diag = {}
        res, sec = host_s(lambda: slam.slam_offline(model, log.ranges, cfg, diag=diag,
                                                    timestamps=log.timestamps))
        poses = res.poses.cpu().numpy()
        if res.poses.device.type != "cuda" or not np.isfinite(poses).all() \
                or len(diag["timing"]["rounds"]) != cfg.rounds:
            raise AssertionError(f"slam_offline(use_correlative=False, use_submaps={use_submaps}) "
                                 f"did not run its {cfg.rounds} rounds on cuda")
        odo_err = float(np.abs(res.odo_poses.cpu().numpy() - kept["poses"]).max())
        if not odo_err <= CARD_FRONT_ATOL:
            raise AssertionError(f"slam_offline's odometry is {odo_err} from the committed front end")
        ate_odo, ate = ate_of(res.odo_poses.cpu(), log.gt_pose), ate_of(poses, log.gt_pose)
        phase("slam-icp", f"use_submaps={use_submaps}, slam_offline end to end: {log.n_scans} scans "
                          f"in {sec:.3f}s (frontend {diag['timing']['frontend']:.3f}s, rounds s "
                          f"{[round(x, 3) for x in diag['timing']['rounds']]}); chi2 "
                          f"{float(res.chi2):.4f}; ATE odometry {ate_odo:.4f} m -> {ate:.4f} m; "
                          f"front end against the committed one max |dpose| {odo_err:.2e}; {smi}")
        held("end to end", int(res.n_loops), ate, JAX_SLAM_ICP_FROM_CARD_FRONT[use_submaps])


def features_phase(log, smi):
    """Feature-RANSAC verification (phase 11) of one round's candidates
    and of the pairs of anchors one and two apart (0.7-1.4 m), which the
    verifier accepts in good part (the round's candidates lie farther
    apart, and it accepts none of them)."""
    from laser_slam_tpu_torch.features import describe_features, detect_features
    from laser_slam_tpu_torch.features.detector import MAX_FEATURES
    from laser_slam_tpu_torch.features.ransac import candidate_correspondences, draw_hypotheses
    from laser_slam_tpu_torch.graph import loop_closure as lc
    from laser_slam_tpu_torch.runtime import slam

    dev = torch.device("cuda")
    model, cfg = log.model, slam.SlamConfig()
    (_, _, _, anchor_scans, anchor_poses, _, _, _) = slam._frontend(
        model, cfg, torch.as_tensor(log.ranges, device=dev), log.timestamps)
    # The candidates the ICP branch's first round verifies, then the near
    # pairs.
    lo, hi = lc.submap_bboxes(model, anchor_scans, anchor_poses)
    wave = lc.select_candidates(lc.gate_matrix(anchor_poses[:, :2], lo, hi, radius=cfg.loop_radius),
                                anchor_poses[:, :2], cfg.max_loops)
    a = anchor_poses.shape[0]
    i = torch.arange(a, device=dev)
    near_src = torch.cat([i[: a - 1], i[: a - 2]])
    near_dst = torch.cat([i[1:], i[2:]])
    cand = lc.LoopCandidates(torch.cat([wave.src, near_src]), torch.cat([wave.dst, near_dst]),
                             torch.cat([wave.valid, torch.ones_like(near_src, dtype=torch.bool)]))
    gen = torch.Generator(device=dev).manual_seed(0)
    lc.verify_loops_features(model, anchor_scans, anchor_poses, cand, gen)      # warm-up
    draws = []

    def drawing(*pair):
        draws.append(draw_hypotheses(candidate_correspondences(*pair)[2], gen))
        return draws[-1]

    out, sec = host_s(lambda: lc._verify_features(model, anchor_scans, anchor_poses, cand, drawing))
    # The same draws on the CPU.
    to_cpu = lambda x: type(x)(*(y.cpu() for y in x))                            # noqa: E731
    host = lc.verify_loops_features_at(model, to_cpu(anchor_scans), anchor_poses.cpu(),
                                       to_cpu(cand), *(d.cpu() for d in draws[-1]))

    def correspondences(scans, src, dst):
        """Each pair's features and descriptor correspondences, on the
        CPU: where they agree between the devices, so must the verifier."""
        feats = detect_features(model, scans)
        descs = describe_features(model, scans, feats)
        j, ok, _ = candidate_correspondences(type(feats)(*(x[src] for x in feats)), descs[src],
                                             type(feats)(*(x[dst] for x in feats)), descs[dst])
        return feats.beam[src].cpu(), feats.beam[dst].cpu(), torch.where(ok, j, -1).cpu()

    # χ² distances that are equal in exact arithmetic differ in the last
    # bit between the devices (summation order) and break ties differently,
    # as tests/test_torch_features.py finds on the CPU against JAX.
    same = np.ones(cand.src.shape[0], dtype=bool)
    for x, y in zip(correspondences(anchor_scans, cand.src, cand.dst),
                    correspondences(to_cpu(anchor_scans), cand.src.cpu(), cand.dst.cpu())):
        same &= (x == y).all(dim=1).numpy()
    acc_c, acc_h = out.accept.cpu().numpy(), host.accept.numpy()
    n_wave = wave.src.shape[0]
    both = same & acc_c & acc_h
    q_c, q_h = out.quality.cpu().numpy(), host.quality.numpy()
    # An inlier at the 0.4 m edge can flip with the last bit of a residual;
    # the refined pose moves with it.
    same_inliers = both & (q_c == q_h)
    rel_err = float(np.abs(out.rel.cpu().numpy() - host.rel.numpy())[same_inliers].max(initial=0.0))
    q_err = float(np.abs(q_c - q_h)[both].max(initial=0.0) * MAX_FEATURES)
    phase("features", json.dumps({
        "anchors": a, "candidates": int(cand.valid.sum()), "of_them_round": int(wave.valid.sum()),
        "verify_loops_features_s": sec, "pairs_per_s": int(cand.valid.sum()) / sec,
        "accepted_round": int(acc_c[:n_wave].sum()), "accepted_near": int(acc_c[n_wave:].sum()),
        "accepted_cpu_same_draws": int(acc_h.sum()),
        "pairs_same_correspondences_cuda_cpu": int(same.sum()),
        "accept_differs_on_those": int((acc_c != acc_h)[same].sum()),
        "accepted_both_on_those": int(both.sum()), "of_them_same_inliers": int(same_inliers.sum()),
        "inliers_mean_accepted": float(q_c[acc_c].mean() * MAX_FEATURES) if acc_c.any() else 0.0,
        "max_abs_inliers_diff_accepted": q_err,
        "max_abs_rel_diff_accepted_same_inliers": rel_err, "card": smi}))
    if acc_c[n_wave:].sum() < FEATURES_MIN_NEAR_ACCEPTED:
        raise AssertionError(f"feature verification accepted {int(acc_c[n_wave:].sum())} near "
                             f"pairs on the card, fewer than {FEATURES_MIN_NEAR_ACCEPTED}")
    if same.mean() < 0.9 or (acc_c != acc_h)[same].sum() > 0.02 * same.sum() \
            or same_inliers.sum() < 0.9 * acc_c[same].sum() or rel_err > 1e-3 or q_err > 1:
        raise AssertionError("feature verification on the card disagrees with the CPU's")


def floor_grid(log, dev, frame=None):
    """The synthetic floor as the robot path's map: the log's scans
    integrated at its ground-truth poses into a ``ROBOT_GRID_RES`` grid
    that covers the floor plan with a ``ROBOT_GRID_MARGIN`` margin, in the
    world frame or, with ``frame`` (a pose), in that pose's frame (the
    online session's frame is the first scan's pose). Returns the grid and
    the poses ``[T, 3]`` in that frame."""
    import synthetic_log as synth
    from laser_slam_tpu_torch.core import se2
    from laser_slam_tpu_torch.mapping import occupancy as occ
    from laser_slam_tpu_torch.ops import preprocess as pp

    origin = np.zeros(3) if frame is None else np.asarray(frame, np.float64)
    poses = se2.np_relative(origin[None], log.gt_pose.astype(np.float64)).astype(np.float32)
    walls = synth.floor_plan()
    ends = np.concatenate([walls[:, :2], walls[:, 2:]])
    corners = se2.np_relative(origin[None], np.concatenate([ends, np.zeros((len(ends), 1))], 1))
    lo = corners[:, :2].min(0) - ROBOT_GRID_MARGIN
    hi = corners[:, :2].max(0) + ROBOT_GRID_MARGIN
    res = ROBOT_GRID_RES
    spec = occ.GridSpec2D(float(lo[0]), float(lo[1]), res,
                          int(np.ceil((hi[0] - lo[0]) / res)), int(np.ceil((hi[1] - lo[1]) / res)))
    scans = pp.preprocess(torch.as_tensor(log.ranges, device=dev), log.model)
    grid = occ.integrate_scans(occ.empty_grid(spec, device=dev), log.model, scans,
                               torch.as_tensor(poses, device=dev))
    return grid, poses


def nearest_pose(poses, xy_world, log):
    """The pose (in ``poses``' frame) of the log's scan nearest a world
    point."""
    i = int(np.argmin(np.linalg.norm(log.gt_pose[:, :2] - np.asarray(xy_world), axis=1)))
    return poses[i]


def robot_mapping(K, log, grid, poses, smi, dev, tmp_dir):
    """``[robot] mapping``: ``RobotController`` in mapping mode with the
    floor grid and its portal, fed the log's first ``ROBOT_SCANS`` scans
    with their odometry as fast as it takes them, ``control_tick`` after
    every scan; a localhost console sends PING, GOTO (a goal in another
    room), POSE, STATE and MAP. The card's local map is then held against
    a ``LocalMapService`` on the CPU fed the same scans and poses. Returns
    K1's batch-entry launches."""
    import base64
    import socket
    import zlib

    from laser_slam_tpu_torch.app import RobotController
    from laser_slam_tpu_torch.app.config import RobotConfig
    from laser_slam_tpu_torch.nav import local_map, planner

    bot = RobotController(log.model, config=RobotConfig(log_file=os.path.join(tmp_dir, "robot.log")),
                          work_mode="mapping", localization_grid=grid, enable_portal=True,
                          device=dev)
    if bot.tasks.grid.log_odds.device != grid.log_odds.device or bot.slam.device.type != dev.type:
        raise AssertionError("RobotController does not run on the device it was given")
    streamed, stream_s = [], []
    stream_in = bot.local_map.stream_in

    def recording(scan, pose):
        t0 = time.perf_counter()
        out = stream_in(scan, pose)
        stream_s.append(time.perf_counter() - t0)
        streamed.append((scan, np.array(pose)))
        return out

    bot.local_map.stream_in = recording
    goal = nearest_pose(poses, ROBOT_GOTO_WORLD, log)[:2]
    answers = {}
    scan_s, tick_s, states = [], [], []
    K.match_psm_fused.launches = K.odometry_chain_fused.launches = 0
    try:
        for i, r in enumerate(log.ranges[:ROBOT_SCANS]):
            bot.on_odometry(*log.laser_pose[i])
            t0 = time.perf_counter()
            pose = bot.on_scan_main(r)
            scan_s.append(time.perf_counter() - t0)
            if pose is None or not np.isfinite(pose).all():
                raise AssertionError(f"scan {i}: no finite pose from on_scan_main")
            if i == ROBOT_CONSOLE_AT:
                with socket.create_connection(("127.0.0.1", bot.portal.port), timeout=30) as c:
                    f = c.makefile("rw", encoding="utf-8", newline="\n")
                    for cmd in ("PING", f"GOTO {goal[0]:.4f} {goal[1]:.4f}", "POSE", "STATE", "MAP"):
                        f.write(cmd + "\n")
                        f.flush()
                        answers[cmd.split()[0]] = f.readline().strip()
            t0 = time.perf_counter()
            bot.control_tick()
            tick_s.append(time.perf_counter() - t0)
            states.append(bot.tasks.state.value)
        launches = K.match_psm_fused.launches
    finally:
        bot.shutdown()
    pose_answer = [float(x) for x in answers["POSE"].split()[1:]]
    map_answer = answers["MAP"].split()
    cells = zlib.decompress(base64.b64decode(map_answer[4]))
    if (answers["PING"] != "PONG" or answers["GOTO"] != "OK" or answers["STATE"] != "STATE planning"
            or len(pose_answer) != 3 or not np.isfinite(pose_answer).all()
            or map_answer[1:4] != ["128", "128", "0.100"] or len(cells) != 128 * 128):
        raise AssertionError(f"the portal answered {answers}")
    if "tracking" not in states and "turning" not in states:
        raise AssertionError(f"the GOTO was never followed: states {sorted(set(states))}")
    # The card's local map against the CPU's, fed the same scans and poses.
    cpu = local_map.LocalMapService(log.model, device="cpu")
    for scan, pose in streamed:
        cpu.stream_in(type(scan)(*(x.cpu() for x in scan)), pose)
    card = bot.local_map.map
    origin_equal = torch.equal(card.origin_cell.cpu(), cpu.map.origin_cell)
    map_err = float((card.log_odds.cpu() - cpu.map.log_odds).abs().max())
    # One plan of the floor alone: its time and its device operations.
    start = torch.as_tensor(poses[0, :2], device=dev)
    goal_t = torch.as_tensor(goal, device=dev)
    plan = lambda: planner.plan_path(grid, start, goal_t)                  # noqa: E731
    plan_ms = host_ms(plan, 3)
    _, plan_ops, plan_busy, _ = trace(plan) if dev.type == "cuda" else (0, 0, 0.0, {})
    stream_alone_ms = host_ms(lambda: stream_in(*streamed[-1]), 20)
    phase("robot", json.dumps({
        "mapping": True, "scans": ROBOT_SCANS, "on_scan_main": percentiles(scan_s),
        "control_tick": percentiles(tick_s), "stream_in_in_path": percentiles(stream_s),
        "stream_in_alone_ms": stream_alone_ms, "states": sorted(set(states)),
        "plan_ms": plan_ms, "plan_device_ops": plan_ops, "plan_device_busy_s": plan_busy,
        "plan_grid": list(grid.log_odds.shape), "k1_two_pair_launches": launches,
        "portal": answers["STATE"], "local_map_origin_equal_cpu": origin_equal,
        "local_map_max_abs_diff_cpu": map_err, "card": smi}))
    if not origin_equal or not map_err <= ROBOT_MAP_ATOL:
        raise AssertionError(f"local map on the card against the CPU: origin equal {origin_equal}, "
                             f"max |dlog-odds| {map_err} (bound {ROBOT_MAP_ATOL})")
    return launches


def robot_drive(log, grid, poses, smi, dev):
    """``[robot] drive``: ``TaskEngine`` at its defaults on the floor grid
    (world frame) drives a simulated robot through a two-leg path from room
    1 through its doorway into the hall and along it (``DRIVE_LEGS_WORLD``,
    snapped to the log's ground truth): each tick a scan is
    ray-cast at the true pose, preprocessed and stepped, and ``(v, ω)`` is
    integrated over ``DRIVE_DT``. Held: the engine reaches DONE, no pose
    lies in an inflated obstacle cell, every ``v`` under its zone's cap,
    the first plan identical to the CPU's, the dodge on every 50th tick's
    scan the same on the card and on the CPU."""
    from laser_slam_tpu_torch.app.task import TaskEngine, TaskState
    from laser_slam_tpu_torch.localization.raycast import simulate_scan
    from laser_slam_tpu_torch.mapping.occupancy import OccupancyGrid
    from laser_slam_tpu_torch.nav import controller, local_planner, planner
    from laser_slam_tpu_torch.ops import preprocess as pp

    model = log.model
    eng = TaskEngine(model, grid, device=dev)
    start = nearest_pose(poses, DRIVE_LEGS_WORLD[0], log).astype(np.float64)
    legs = [nearest_pose(poses, xy, log)[:2] for xy in DRIVE_LEGS_WORLD[1:]]
    eng.add_path(legs)
    blocked = planner.inflate_obstacles(grid, eng.robot_radius).cpu().numpy()
    spec = grid.spec
    caps = [z[1] for z in controller.ZONES] + [controller.FREE_SPEED]
    plans = []
    plan = eng._plan

    def timed_plan(*a):
        t0 = time.perf_counter()
        out = plan(*a)
        plans.append((a[0].copy(), a[1].copy(), out[1], out[2], time.perf_counter() - t0))
        return out

    eng._plan = timed_plan
    pose, tick_s, dodge_checks, inside = start.copy(), [], 0, 0
    for tick in range(DRIVE_MAX_TICKS):
        ranges = simulate_scan(grid, model, torch.as_tensor(pose, dtype=torch.float32, device=dev))
        scan = pp.preprocess(ranges[None], model)
        scan = type(scan)(*(x[0] for x in scan))
        t0 = time.perf_counter()
        cmd = eng.step(pose.astype(np.float32), scan)
        v, omega, zone = torch.stack([cmd.v, cmd.omega, cmd.zone.to(cmd.v.dtype)]).cpu().numpy()
        tick_s.append(time.perf_counter() - t0)
        cx, cy = (int(np.floor((pose[0] - spec.origin_x) / spec.resolution)),
                  int(np.floor((pose[1] - spec.origin_y) / spec.resolution)))
        inside += bool(blocked[cy, cx])
        if v > caps[int(zone)] + 1e-6:
            raise AssertionError(f"tick {tick}: v {v} above zone {int(zone)}'s cap")
        if tick % DRIVE_DODGE_EVERY == 0:
            got = [local_planner.dodge_path(model, s) for s in (scan, type(scan)(*(x.cpu() for x in scan)))]
            if not all(torch.equal(a.cpu(), b) for a, b in zip(*got)):
                raise AssertionError(f"tick {tick}: the dodge on the card differs from the CPU's")
            dodge_checks += 1
        if eng.state in (TaskState.DONE, TaskState.FAILED):
            break
        pose[0] += DRIVE_DT * v * np.cos(pose[2])
        pose[1] += DRIVE_DT * v * np.sin(pose[2])
        pose[2] = (pose[2] + DRIVE_DT * omega + np.pi) % (2 * np.pi) - np.pi
    # The first plan again on the CPU.
    s0, g0, path0, n0, _ = plans[0]
    cpu = planner.plan_path(OccupancyGrid(grid.log_odds.cpu(), spec), torch.as_tensor(s0),
                            torch.as_tensor(g0))
    same_plan = (int(cpu.n_valid) == n0 and np.array_equal(cpu.path.numpy(), path0))
    phase("robot", json.dumps({
        "drive": True, "state": eng.state.value, "ticks": tick + 1, "plans": eng.n_plans,
        "replans": eng._replans, "dodges": eng.n_dodges, "tick": percentiles(tick_s),
        "plan_s": [p[4] for p in plans], "first_plan_n_valid": n0,
        "first_plan_same_as_cpu": same_plan, "dodge_checks_card_cpu": dodge_checks,
        "ticks_in_inflated_cells": inside, "end_xy": [float(pose[0]), float(pose[1])],
        "goal_xy": [float(x) for x in legs[-1]], "card": smi}))
    if eng.state is not TaskState.DONE:
        raise AssertionError(f"the drive ended {eng.state.value} after {tick + 1} ticks")
    if inside:
        raise AssertionError(f"{inside} ticks put the robot in an inflated obstacle cell")
    if not same_plan:
        raise AssertionError("the first plan on the card differs from the CPU's")


def robot_phase(K, log, smi, tmp_dir):
    """The robot application path (phase 12) on ``cuda``: ``[robot]
    mapping``, then ``[robot] drive``. Returns K1's batch-entry launches
    of the mapping run, which must be one a scan after the first."""
    dev = torch.device("cuda")
    grid, poses = floor_grid(log, dev, frame=log.gt_pose[0])
    launches = robot_mapping(K, log, grid, poses, smi, dev, tmp_dir)
    if launches != ROBOT_SCANS - 1:
        raise AssertionError(f"{ROBOT_SCANS} scans through RobotController launched K1's batch "
                             f"entry {launches} times")
    world, world_poses = floor_grid(log, dev)
    robot_drive(log, world, world_poses, smi, dev)
    return launches


def fusion_world(gen):
    """The simulated world of ``[fusion]``, every draw from ``gen`` (a CPU
    generator): ``FUSION_LANDMARKS`` landmarks in a square of
    ``FUSION_WORLD`` m; a robot driving a circle of ``FUSION_RADIUS`` m
    about its centre with noisy steps; each step's sightings of the
    nearest landmarks within ``FUSION_SENSOR_RANGE`` (at most
    ``FUSION_SIGHTINGS``) as noisy range and bearing. Returns numpy arrays:
    landmarks ``[L, 2]``, the commanded step ``[3]``, true poses ``[T + 1,
    3]``, sighted ids ``[T, S]`` (-1 pads), ranges and bearings ``[T, S,
    2]``, and the sighting counts ``[T]``."""
    from laser_slam_tpu_torch.core import se2

    half = FUSION_WORLD / 2
    lms = (torch.rand(FUSION_LANDMARKS, 2, generator=gen, dtype=torch.float64) * 2 - 1) * half
    lms = lms.numpy()
    step = np.array([FUSION_STEP, 0.0, FUSION_STEP / FUSION_RADIUS])
    noise = torch.randn(FUSION_STEPS, 3, generator=gen, dtype=torch.float64).numpy()
    truth = np.zeros((FUSION_STEPS + 1, 3))
    truth[0] = (FUSION_RADIUS, 0.0, np.pi / 2)
    ids = np.full((FUSION_STEPS, FUSION_SIGHTINGS), -1, np.int64)
    z = np.zeros((FUSION_STEPS, FUSION_SIGHTINGS, 2))
    count = np.zeros(FUSION_STEPS, np.int64)
    zn = torch.randn(FUSION_STEPS, FUSION_SIGHTINGS, 2, generator=gen, dtype=torch.float64).numpy()
    for t in range(FUSION_STEPS):
        truth[t + 1] = se2.np_compose(truth[t], step + noise[t] * FUSION_MOTION_SIGMA)
        d = lms - truth[t + 1, :2]
        rng = np.hypot(d[:, 0], d[:, 1])
        near = np.argsort(rng, kind="stable")[:FUSION_SIGHTINGS]
        near = near[rng[near] < FUSION_SENSOR_RANGE]
        count[t] = len(near)
        ids[t, :len(near)] = near
        brg = se2.np_normalize_angle(np.arctan2(d[near, 1], d[near, 0]) - truth[t + 1, 2])
        z[t, :len(near)] = np.stack([rng[near], brg], -1) + zn[t, :len(near)] * FUSION_OBS_SIGMA
    return lms, step, truth, ids, z, count


def fusion_phase(smi):
    """The landmark and Kalman filters (``fusion/kalman``,
    ``fusion/slam_schemes``) on ``cuda`` at full size, the same draws on
    the card and on the CPU. Prints ``[fusion]`` lines; raises when a
    bound is missed."""
    from laser_slam_tpu_torch.core import se2
    from laser_slam_tpu_torch.fusion import kalman as kf
    from laser_slam_tpu_torch.fusion import slam_schemes as ss

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    # Every draw of the phase comes from this one CPU generator; fastSLAM's
    # card and CPU runs replay the same stretch of it.
    gen = torch.Generator().manual_seed(FUSION_SEED)
    lms, step, truth, ids, z, count = fusion_world(gen)
    T = FUSION_STEPS
    R = np.diag(np.square(FUSION_OBS_SIGMA)).astype(np.float32)
    on = {d: dict(step=torch.tensor(step, dtype=torch.float32, device=d),
                  ids=torch.as_tensor(ids, device=d), z=torch.tensor(z, dtype=torch.float32, device=d),
                  R=torch.tensor(R, device=d), lms=torch.tensor(lms, dtype=torch.float32, device=d))
          for d in (dev, torch.device("cpu"))}
    q_pose = np.square(FUSION_MOTION_SIGMA).astype(np.float32)

    # -- the covariance filter through jacfwd: localization against the
    # known landmarks, the nearest two sightings a step in one update.
    def cov_filter(steps, start=None):
        c = on[dev]
        s = start or kf.init(torch.tensor(truth[0], dtype=torch.float32), 1e-4, device=dev)
        R2 = torch.block_diag(c["R"], c["R"])
        means = []
        for t in range(steps):
            s = kf.predict(s, lambda x: se2.compose(x, c["step"]), torch.diag(torch.tensor(q_pose, device=dev)))
            k = min(int(count[t]), 2)
            if k:
                lm, zk = c["lms"][c["ids"][t, :k]], c["z"][t, :k]

                def h(x, lm=lm):
                    d = lm - x[:2]
                    return torch.stack([torch.sqrt(torch.sum(d * d, dim=-1)),
                                        torch.atan2(d[:, 1], d[:, 0]) - x[2]], dim=-1).reshape(-1)

                hb = h(s.mean).view(k, 2)[:, 1]
                zk = torch.stack([zk[:, 0], hb + se2.normalize_angle(zk[:, 1] - hb)], dim=-1)
                s = kf.update(s, h, zk.reshape(-1), R2[:2 * k, :2 * k])
            means.append(s.mean)
        return s, torch.stack(means)

    (cov_state, cov_means), cov_s = host_s(lambda: cov_filter(T))
    cov_err = np.linalg.norm(cov_means.cpu().numpy()[:, :2] - truth[1:, :2], axis=1)
    _, cov_ops, _, _ = trace(lambda: cov_filter(FUSION_TRACE_STEPS, cov_state))

    # -- the UdU filter against the covariance filter: a constant-velocity
    # state of 6 (x, y, θ and their rates), the pose observed.
    n, dt = 6, 0.1
    F = torch.eye(n, device=dev)
    F[:3, 3:] = dt * torch.eye(3, device=dev)
    qd = torch.tensor([1e-5, 1e-5, 1e-6, 1e-3, 1e-3, 1e-4], device=dev)
    Hm = torch.eye(n, device=dev)[:3]
    rd = torch.tensor([0.05 ** 2, 0.05 ** 2, 0.01 ** 2], device=dev)
    meas_noise = torch.randn(T, 3, generator=gen)
    zpose = torch.tensor(truth[1:], dtype=torch.float32, device=dev) + meas_noise.to(dev) * rd.sqrt()
    init6 = torch.cat([zpose[0], torch.zeros(3, device=dev)])

    def ud_vs_cov(steps, us=None, ks=None):
        us = us or kf.ud_init(init6, 1.0)
        ks = ks or kf.init(init6, 1.0)
        gap = []
        for t in range(steps):
            us = kf.thornton_predict(us, F, qd)
            ks = kf.predict_linear(ks, F, torch.diag(qd))
            zt = zpose[t]
            # Heading innovation wrapped on the device, the same for both.
            us = kf.ud_update(us, Hm, torch.cat([zt[:2] - us.mean[:2],
                                                 se2.normalize_angle(zt[2:] - us.mean[2:3])]), rd)
            ks = kf.update_linear(ks, Hm, torch.cat([zt[:2] - ks.mean[:2],
                                                     se2.normalize_angle(zt[2:] - ks.mean[2:3])]),
                                  torch.diag(rd))
            gap.append(torch.stack([torch.max(torch.abs(us.mean - ks.mean)),
                                    torch.max(torch.abs(us.cov() - ks.cov))]))
        return us, ks, torch.stack(gap)

    (ud_state, kc_state, gap), ud_s = host_s(lambda: ud_vs_cov(T))
    gap = gap.cpu().numpy()
    ud_err = float(np.linalg.norm(ud_state.mean.cpu().numpy()[:2] - truth[T, :2]))
    _, ud_ops, _, _ = trace(lambda: ud_vs_cov(FUSION_TRACE_STEPS, ud_state, kc_state))

    # -- EKF-SLAM with L_max = 128, on the card and on the CPU.
    def ekf_run(d, steps, e=None):
        c = on[d]
        t0 = 0 if e is None else FUSION_CPU_STEPS
        e = e or ss.ekfslam_init(torch.tensor(truth[0], dtype=torch.float32), FUSION_EKF_SLOTS,
                                 device=d)
        for t in range(t0, t0 + steps):
            e = ss.ekfslam_predict(e, c["step"], torch.diag(torch.tensor(q_pose, device=d)))
            for k in range(int(count[t])):
                e = ss.ekfslam_observe(e, c["ids"][t, k], c["z"][t, k], c["R"])
        return e

    # The CPU runs the first FUSION_CPU_STEPS steps (a 259² Joseph update
    # costs it ~50 ms a step); the card's state there is held to the CPU's.
    def ekf_card():
        e = ekf_run(dev, FUSION_CPU_STEPS)
        return e, ekf_run(dev, T - FUSION_CPU_STEPS, e)

    (ekf_at, ekf), ekf_s = host_s(ekf_card)
    ekf_cpu = ekf_run(torch.device("cpu"), FUSION_CPU_STEPS)
    ekf_gap = float((ekf_at.mean.cpu() - ekf_cpu.mean).abs().max())
    seen = np.zeros(FUSION_EKF_SLOTS, bool)
    seen[np.unique(ids[ids >= 0])] = True
    if not np.array_equal(ekf.lm_valid.cpu().numpy(), seen):
        raise AssertionError("EKF-SLAM's valid landmark slots are not the sighted landmarks")
    ekf_lm_err = np.linalg.norm(ekf.landmarks().cpu().numpy()[seen] - lms[seen[:FUSION_LANDMARKS]],
                                axis=1)
    ekf_pose_err = float(np.linalg.norm(ekf.robot().cpu().numpy()[:2] - truth[T, :2]))
    _, ekf_ops, _, _ = trace(lambda: ekf_run(dev, FUSION_TRACE_STEPS, ekf))

    # -- fastSLAM, 4096 particles × 64 landmarks, card and CPU on the same
    # draws, the CPU up to the first resample.
    sigma = torch.tensor(FUSION_MOTION_SIGMA, dtype=torch.float32)
    draws = gen.get_state()

    def replay():
        return torch.Generator().set_state(draws)

    def fast_run(d, steps, gen, stop_at_resample=False, s=None):
        c = on[d]
        s = s or ss.fastslam_init(torch.tensor(truth[0], dtype=torch.float32), FUSION_PARTICLES,
                                  FUSION_FAST_SLOTS, device=d)
        first = None
        for t in range(steps):
            s = ss.fastslam_predict(s, gen, c["step"], sigma)
            for k in range(int(count[t])):
                s = ss.fastslam_observe(s, c["ids"][t, k], c["z"][t, k], c["R"])
            if float(ss.fastslam_neff(s)) < FUSION_PARTICLES / 2:
                if first is None:
                    first = t
                    if stop_at_resample:
                        return s, first
                s = ss.fastslam_resample(s, gen)
        return s, first

    (fast, first_resample), fast_s = host_s(lambda: fast_run(dev, FUSION_FAST_STEPS, gen))
    if first_resample is None:
        raise AssertionError("fastSLAM never resampled")
    card_to_first, _ = fast_run(dev, FUSION_FAST_STEPS, replay(), stop_at_resample=True)
    cpu_to_first, cpu_first = fast_run(torch.device("cpu"), FUSION_FAST_STEPS, replay(),
                                       stop_at_resample=True)
    fast_gap = float((card_to_first.poses.cpu() - cpu_to_first.poses).abs().max())
    est_pose, est_map = ss.fastslam_estimate(fast)
    fast_seen = np.unique(ids[:FUSION_FAST_STEPS][ids[:FUSION_FAST_STEPS] >= 0])
    fast_pose_err = float(np.linalg.norm(est_pose.cpu().numpy()[:2] - truth[FUSION_FAST_STEPS, :2]))
    fast_lm_err = np.linalg.norm(est_map.cpu().numpy()[fast_seen] - lms[fast_seen], axis=1)
    _, fast_ops, _, _ = trace(lambda: fast_run(dev, FUSION_TRACE_STEPS, gen, s=fast))
    peak = torch.cuda.max_memory_allocated() / 2**30

    stats = {
        "covariance_filter": {"steps": T, "ms_per_step": cov_s / T * 1e3,
                              "device_ops_per_step": cov_ops / FUSION_TRACE_STEPS,
                              "pos_err_mean_m": float(cov_err.mean()),
                              "pos_err_p90_m": float(np.percentile(cov_err, 90))},
        "udu_vs_covariance": {"steps": T, "state": n, "ms_per_step_both": ud_s / T * 1e3,
                              "device_ops_per_step_both": ud_ops / FUSION_TRACE_STEPS,
                              "max_mean_gap": float(gap[:, 0].max()),
                              "max_cov_gap": float(gap[:, 1].max()), "pos_err_end_m": ud_err},
        "ekf_slam": {"steps": T, "slots": FUSION_EKF_SLOTS, "state": 3 + 2 * FUSION_EKF_SLOTS,
                     "landmarks_seen": int(seen.sum()), "sightings": int(count.sum()),
                     "ms_per_step": ekf_s / T * 1e3, "device_ops_per_step": ekf_ops / FUSION_TRACE_STEPS,
                     "card_vs_cpu_steps": FUSION_CPU_STEPS, "card_vs_cpu_max_abs_mean": ekf_gap, "pose_err_end_m": ekf_pose_err,
                     "landmark_err_mean_m": float(ekf_lm_err.mean()),
                     "landmark_err_max_m": float(ekf_lm_err.max())},
        "fastslam": {"steps": FUSION_FAST_STEPS, "particles": FUSION_PARTICLES,
                     "slots": FUSION_FAST_SLOTS, "ms_per_step": fast_s / FUSION_FAST_STEPS * 1e3,
                     "device_ops_per_step": fast_ops / FUSION_TRACE_STEPS,
                     "first_resample_step": first_resample, "cpu_first_resample_step": cpu_first,
                     "card_vs_cpu_max_abs_pose_to_first_resample": fast_gap,
                     "pose_err_end_m": fast_pose_err, "landmark_err_mean_m": float(fast_lm_err.mean())},
        "peak_device_memory_gib": peak, "card": smi,
    }
    phase("fusion", json.dumps(stats))
    checks = {
        "covariance filter position error": float(cov_err.mean()) < FUSION_POS_ERR,
        "UdU against covariance filter, means": float(gap[:, 0].max()) < FUSION_UDU_ATOL,
        "EKF-SLAM card against CPU": ekf_gap < FUSION_CARD_CPU_ATOL,
        "EKF-SLAM landmarks": float(ekf_lm_err.mean()) < FUSION_LM_ERR,
        "fastSLAM card against CPU up to the first resample": fast_gap < FUSION_CARD_CPU_ATOL
        and cpu_first == first_resample,
        "fastSLAM pose": fast_pose_err < FUSION_FAST_POS_ERR,
        "fastSLAM landmarks": float(fast_lm_err.mean()) < FUSION_LM_ERR * 2,
    }
    missed = [k for k, ok in checks.items() if not ok]
    if missed:
        raise AssertionError(f"[fusion] bounds missed: {missed}")


def anchor_graph(slam_diag):
    """``[slam]``'s anchor graph: the odometry chain of the anchors
    (information ``INFO_ADJ`` times each edge's weight) and the loops the
    final solve used (``INFO_LOOP``, DCS), from the linear (LAGO)
    initialization of the odometry estimate, as ``slam_offline`` starts
    its LM."""
    from laser_slam_tpu_torch.core import se2
    from laser_slam_tpu_torch.graph.solve import KERNEL_DCS, KERNEL_HUBER
    from laser_slam_tpu_torch.runtime.slam import INFO_ADJ, INFO_LOOP

    bank = slam_diag["bank"]
    used = bank["used"] & bank["act"]
    odo = slam_diag["odo_anchor_poses"]
    a = odo.shape[0]
    seq = np.arange(a - 1)
    rel_seq = se2.np_relative(odo[:-1], odo[1:])
    info = np.concatenate([np.eye(3)[None] * INFO_ADJ * slam_diag["seq_weight"][:, None, None],
                           np.tile(np.eye(3) * INFO_LOOP, (int(used.sum()), 1, 1))])
    kernel = np.concatenate([np.full(a - 1, KERNEL_HUBER), np.full(int(used.sum()), KERNEL_DCS)])
    from laser_slam_tpu_torch.graph.solve import linear_initialize

    g = graph_on_card(odo, np.concatenate([seq, bank["src"][used]]),
                      np.concatenate([seq + 1, bank["dst"][used]]),
                      np.concatenate([rel_seq, bank["rel"][used]]), info, kernel)
    return linear_initialize(g)


def chain_graph(odo_poses, gt):
    """All scans' odometry chain (``INFO_ADJ``) and ``PARALLEL_CG_LOOPS``
    loop edges from the ground truth between scans at least
    ``PARALLEL_CG_MIN_GAP`` apart whose true positions lie within 1 m
    (``INFO_LOOP``, DCS), from the linear initialization of the odometry
    estimate: past ``DENSE_SOLVER_MAX_V`` vertices, the solver's CG route."""
    from laser_slam_tpu_torch.core import se2
    from laser_slam_tpu_torch.graph.solve import KERNEL_DCS, KERNEL_HUBER
    from laser_slam_tpu_torch.runtime.slam import INFO_ADJ, INFO_LOOP

    t = odo_poses.shape[0]
    d = np.linalg.norm(gt[:, None, :2] - gt[None, :, :2], axis=-1)
    i, j = np.nonzero((d < 1.0) & (np.arange(t)[None, :] - np.arange(t)[:, None] >= PARALLEL_CG_MIN_GAP))
    pick = np.sort(np.random.default_rng(0).choice(len(i), PARALLEL_CG_LOOPS, replace=False))
    i, j = i[pick], j[pick]
    seq = np.arange(t - 1)
    meas = np.concatenate([se2.np_relative(odo_poses[:-1], odo_poses[1:]), se2.np_relative(gt[i], gt[j])])
    info = np.concatenate([np.tile(np.eye(3) * INFO_ADJ, (t - 1, 1, 1)),
                           np.tile(np.eye(3) * INFO_LOOP, (len(i), 1, 1))])
    kernel = np.concatenate([np.full(t - 1, KERNEL_HUBER), np.full(len(i), KERNEL_DCS)])
    from laser_slam_tpu_torch.graph.solve import linear_initialize

    return linear_initialize(graph_on_card(odo_poses, np.concatenate([seq, i]),
                                           np.concatenate([seq + 1, j]), meas, info, kernel))


def graph_on_card(poses, i, j, meas, info, kernel):
    from laser_slam_tpu_torch.graph.solve import PoseGraph

    dev = torch.device("cuda")
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    return PoseGraph(
        poses=f32(poses), v_active=torch.ones(poses.shape[0], dtype=torch.bool, device=dev),
        i=torch.as_tensor(i, dtype=torch.int64, device=dev),
        j=torch.as_tensor(j, dtype=torch.int64, device=dev), meas=f32(meas), info=f32(info),
        e_active=torch.ones(len(i), dtype=torch.bool, device=dev),
        kernel=torch.as_tensor(kernel, dtype=torch.int64, device=dev))


def solve_parity(mesh, g, label, smi):
    """``distributed_optimize`` against ``optimize`` on the card: two plain
    runs give ``optimize``'s own run-to-run spread (its normal equations are
    sums of atomic adds); the distributed run must fall within
    ``max(2 × spread, PARALLEL_SOLVE_FLOOR)`` of the first. With PyTorch's
    deterministic kernels (sorted sums) the spread is gone, and the
    distributed run must then take the same LM steps to the same poses,
    bit for bit."""
    from laser_slam_tpu_torch.graph import solve
    from laser_slam_tpu_torch.parallel.distributed import distributed_optimize

    infos = [{}, {}, {}]
    (a, chi_a), t_a = host_s(lambda: solve.optimize(g, 20, info=infos[0]))
    (b, chi_b), t_b = host_s(lambda: solve.optimize(g, 20, info=infos[1]))
    (d, chi_d), t_d = host_s(lambda: distributed_optimize(mesh, g, 20, info=infos[2]))
    spread = float((a.poses - b.poses).abs().max())
    gap = float((d.poses - a.poses).abs().max())
    bound = max(2.0 * spread, PARALLEL_SOLVE_FLOOR)
    # The same three solves with PyTorch's deterministic kernels (sorted
    # sums instead of atomic adds), for the spread's source.
    det_infos = [{}, {}, {}]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = [solve.optimize(g, 20, info=det_infos[0])[0].poses,
               solve.optimize(g, 20, info=det_infos[1])[0].poses,
               distributed_optimize(mesh, g, 20, info=det_infos[2])[0].poses]
    finally:
        torch.use_deterministic_algorithms(False)
    route = "cg" if g.poses.shape[0] > solve.DENSE_SOLVER_MAX_V else "dense"
    stats = {"vertices": int(g.poses.shape[0]), "edges": int(g.i.shape[0]), "route": route,
             "lm": infos, "lm_deterministic": det_infos, "optimize_s": [t_a, t_b],
             "distributed_optimize_s": t_d,
             "chi2": [float(chi_a), float(chi_b), float(chi_d)],
             "optimize_spread_max_abs": spread, "distributed_vs_optimize_max_abs": gap,
             "bound": bound, "deterministic_spread_max_abs": float((det[0] - det[1]).abs().max()),
             "deterministic_distributed_vs_optimize_max_abs": float((det[2] - det[0]).abs().max()), "chi2_drop": float(solve.weighted_chi2(g)) - float(chi_d), "card": smi}
    phase("parallel", f"{label}: {json.dumps(stats)}")
    if not (gap <= bound and infos[2]["steps"] > 0 and np.isfinite(d.poses.cpu().numpy()).all()
            and torch.equal(det[2], det[0]) and det_infos[2] == det_infos[0]):
        raise AssertionError(f"distributed_optimize disagrees with optimize on {label}: {stats}")


def parallel_phase(K, log, scans, odo_poses, slam_diag, smi, tmp_dir):
    """``parallel/`` on a one-rank NCCL group on the card (phase 14).
    Returns K1's batch-entry launches of its two main-path calls (the
    sharded PSM over the log's pairs and ``training_step``)."""
    import torch.distributed as dist

    import torch_multiproc_worker as worker
    from laser_slam_tpu_torch.core import scan as S
    from laser_slam_tpu_torch.ops import icp, plicp
    from laser_slam_tpu_torch.parallel import distributed as D
    from laser_slam_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
        raise AssertionError("make_mesh() did not start a one-rank NCCL group")
    model = log.model
    ref, cur = pairs(scans, S)

    # a. The sharded matchers against the undistributed calls: at one rank
    # the gather is a copy, so bit for bit.
    K.match_psm_fused.launches = 0
    got, t_sharded = host_s(lambda: D.sharded_batch_match(mesh, model, ref, cur, matcher="psm"))
    launches = K.match_psm_fused.launches
    if launches != 1:
        raise AssertionError(f"sharded PSM launched K1's batch entry {launches} times")
    # The first collective of a new NCCL group sets its communicator up.
    times = {"psm": t_sharded,
             "psm_again": host_s(lambda: D.sharded_batch_match(mesh, model, ref, cur))[1]}
    for name, plain in (("psm", K.match_psm_fused), ("icp", icp.match_icp),
                        ("plicp", plicp.match_plicp)):
        if name != "psm":
            got, times[name] = host_s(lambda: D.sharded_batch_match(mesh, model, ref, cur, matcher=name))
        want = plain(model, ref, cur)
        for field, x, y in zip(want._fields, got, want):
            if x.device.type != "cuda" or not torch.equal(x, y):
                raise AssertionError(f"sharded {name} differs from the undistributed call in {field}")
    phase("parallel", f"sharded_batch_match over {ref.ranges.shape[0]} pairs, one-rank NCCL group: "
                      f"psm (K1 launches {launches}) / icp / plicp equal to the undistributed calls bit "
                      f"for bit; seconds {json.dumps(times)}; {smi}")

    # b., c. The edge-sharded LM against optimize: [slam]'s anchor graph
    # (dense route) and the whole chain with loops (CG route).
    solve_parity(mesh, anchor_graph(slam_diag), "anchor graph of [slam]", smi)
    solve_parity(mesh, chain_graph(odo_poses, log.gt_pose[: odo_poses.shape[0]]),
                 f"odometry chain of all scans + {PARALLEL_CG_LOOPS} loops", smi)

    # d. training_step at B pairs in the dry-run layout.
    dev = torch.device("cuda")
    ref_b, cur_b, true_rel = worker.synthetic_pairs(S.LMS211, PARALLEL_TRAIN_PAIRS, seed=0, device=dev)
    graph = worker.dryrun_graph(PARALLEL_TRAIN_PAIRS, device=dev)
    K.match_psm_fused.launches = 0
    (poses, chi, fail), wall = host_s(lambda: D.training_step(mesh, S.LMS211, ref_b, cur_b, graph))
    train_launches = K.match_psm_fused.launches
    _, warm = host_s(lambda: D.training_step(mesh, S.LMS211, ref_b, cur_b, graph))
    fails = int(fail.sum())
    phase("parallel", f"training_step, {PARALLEL_TRAIN_PAIRS} pairs, {graph.poses.shape[0]} poses, "
                      f"{graph.i.shape[0]} edges: chi2 {float(chi):.6f}, fails {fails}, K1 launches "
                      f"{train_launches}, wall {wall:.4f}s (again {warm:.4f}s); {smi}")
    if fails or train_launches != 1 or not np.isfinite(poses.cpu().numpy()).all():
        raise AssertionError(f"training_step: {fails} fails, {train_launches} K1 launches")
    dist.destroy_process_group()

    # Two ranks on the one card: NCCL takes one rank a card, so the two
    # processes join a gloo group and hand it the card's tensors.
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tools" / "torch_multiproc_worker.py"), f"127.0.0.1:{port}", "2",
         str(pid), "cuda"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if all(p.returncode == 0 for p in procs):
        chis = [o.split("chi2=")[1].split()[0] for o in outs]
        phase("parallel", f"two ranks on one card over gloo with CUDA tensors: chi2 {chis[0]} / "
                          f"{chis[1]} ({'equal' if chis[0] == chis[1] else 'DIFFERENT'}); {smi}")
        if chis[0] != chis[1]:
            raise AssertionError(f"the two ranks' chi2 differ: {chis}")
    else:
        tail = " | ".join(ln for ln in outs[0].splitlines()[-6:] if ln.strip())
        phase("parallel", f"two ranks on one card over gloo with CUDA tensors: not supported here "
                          f"(rank 0 exit {procs[0].returncode}, rank 1 exit {procs[1].returncode}: "
                          f"{tail[-600:]}); the two-rank proof is the CPU test "
                          f"tests/test_torch_multiprocess.py")
    return launches + train_launches


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main() -> None:
    # -- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card")
    if not (ROOT / "laser_slam_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no laser_slam_tpu_torch package beside {__file__}")
    from laser_slam_tpu_torch import cli
    from laser_slam_tpu_torch.core import scan as S
    from laser_slam_tpu_torch.eval import metrics
    from laser_slam_tpu_torch.io.carmen import read_carmen
    from laser_slam_tpu_torch.mapping import occupancy as occ
    from laser_slam_tpu_torch.ops import correlative, odometry, preprocess as pp, psm
    from laser_slam_tpu_torch.ops.cuda import correlative_kernel as V
    from laser_slam_tpu_torch.ops.cuda import icp_nearest_kernel as NK
    from laser_slam_tpu_torch.ops.cuda import psm_kernel as K
    from laser_slam_tpu_torch.ops.cuda import raycast_kernel as RK
    import synthetic_log as synth

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    phase("device", f"{name}; torch {torch.__version__} cuda {torch.version.cuda}; "
                    f"nvidia-smi: {smi}")

    # -- 2. build ---------------------------------------------------------
    for kernel in (K.KERNEL, V.KERNEL, RK.KERNEL, NK.KERNEL):
        t_build = kernel.build()
        ptxas = " | ".join(l.strip() for l in kernel.build_log.splitlines()
                           if "Used" in l or "spill" in l)
        phase("build", f"{kernel.source.relative_to(ROOT)} built in {t_build:.2f}s ({ptxas})")

    # -- 3. kernel parity and timing at full size ---------------------------
    tmp = tempfile.TemporaryDirectory()
    log_path = os.path.join(tmp.name, "synthetic.log")
    ranges, gt, ts = synth.synthetic_log()
    synth.write_carmen(log_path, ranges, gt, ts)
    log = read_carmen(log_path)
    lms211 = log.model
    scans = pp.preprocess(torch.as_tensor(log.ranges, device=dev), lms211)
    ref, cur = pairs(scans, S)

    def batch_parity(model, a, b, label):
        """The batch entry with its epilogue (error reference: the match
        reference) against the plain matcher and the plain error index."""
        fused, index = K.match_psm_fused(model, a, b, error_ref=a)
        st = parity(fused, psm.match_psm(model, a, b), label)
        st["index_rel_err"] = index_parity(index, psm.error_index(model, a, b, fused.pose), label)
        return st

    stats = [batch_parity(lms211, ref, cur,
                          f"{lms211.name} x{ref.ranges.shape[0]}, plain on cuda")]
    rng = np.random.default_rng(7)
    for model in (S.LMS511, S.LMS151):
        r = synth.ray_cast(synth.floor_plan(), gt[:513], model.bearings(torch.float64).numpy())
        r = np.where(r <= synth.MAX_RANGE, r + rng.normal(0.0, synth.NOISE, r.shape), r)
        a, b = pairs(pp.preprocess(torch.as_tensor(r.astype(np.float32), device=dev), model), S)
        stats.append(batch_parity(model, a, b, f"{model.name} x512, plain on cuda"))

    n_pairs = ref.ranges.shape[0]
    batch_ms = cuda_ms(lambda: K.match_psm_fused(lms211, ref, cur), 20)
    batch_index_ms = cuda_ms(lambda: K.match_psm_fused(lms211, ref, cur, error_ref=ref), 20)
    batch_plain_ms = cuda_ms(lambda: psm.match_psm(lms211, ref, cur), 3)
    batch_iters = int(K.match_psm_fused.last_iters.sum())
    # Each scan tensor once (the pair mask is as large as cur.bad).
    batch_bound, batch_bound_by = bound_ms(
        lms211, batch_iters, n_pairs,
        n_bytes(ref.ranges, ref.bad, cur.ranges, cur.bad) + n_pairs * MATCH_IO_BYTES,
        with_index=False)
    phase("timing", f"K1 batch entry, {n_pairs} pairs ({batch_iters} iterations in all): "
                    f"{batch_ms:.4f} ms ({n_pairs / batch_ms * 1e3:.1f} matches/s), with the "
                    f"error-index epilogue {batch_index_ms:.4f} ms, plain {batch_plain_ms:.3f} ms "
                    f"({n_pairs / batch_plain_ms * 1e3:.1f} matches/s), bound "
                    f"{batch_bound:.5f} ms by {batch_bound_by}; {smi}")
    corr, pass2_search = correlative_phase(log, scans, synth, smi)

    # -- 4. main paths ----------------------------------------------------
    with tmp:
        traj, png = os.path.join(tmp.name, "traj.txt"), os.path.join(tmp.name, "map.png")
        K.match_psm_fused.launches = K.odometry_chain_fused.launches = 0
        t0 = time.perf_counter()
        with volume_calls() as calls, search_calls() as searches:
            run = cli.main(["odometry", log_path, "--device", "cuda", "--out", traj, "--map", png])
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        odo_volume_launches = check_volume_launches(calls, "cli odometry")
        # Each pass-2 chunk polishes its re-matches with 15 ICP iterations.
        odo_search_launches = check_search_launches(
            searches, "cli odometry", 15 * odo_volume_launches)
        chain_launches = K.odometry_chain_fused.launches
        step_launches = K.match_psm_fused.launches
        chain_iters = K.odometry_chain_fused.last_iters.cpu().numpy()
        t = run.log.n_scans
        res = run.result
        tensors = [*run.scans, *(x for x in res if x is not None), *run.ate, *run.rpe,
                   run.grid.log_odds]
        if any(x.device.type != "cuda" for x in tensors):
            raise AssertionError("a tensor of the main path is not on cuda")
        poses = res.poses.cpu().numpy()
        if poses.shape != (t, 3) or not np.isfinite(poses).all():
            raise AssertionError(f"bad trajectory: shape {poses.shape}")
        if not np.allclose(np.loadtxt(traj), poses, atol=1e-5):
            raise AssertionError("written trajectory differs from the result")
        with open(png, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError("map PNG not written")
        if chain_launches != 1 or step_launches != 0:
            raise AssertionError(f"keyframe odometry launched K1's chain entry {chain_launches} "
                                 f"times (expected once) and its batch entry {step_launches} times")
        if chain_iters.shape != (t - 1, 2) or chain_iters.min() < 1:
            raise AssertionError("the chain entry did not run every step")
        n_rematch = int(res.rematched.sum())
        if n_rematch <= 0:
            raise AssertionError("pass 2 (correlative re-match) never ran")
        chunks = -(-n_rematch // 128)                 # odometry_keyframe's deep_chunk
        if odo_volume_launches != chunks:
            raise AssertionError(f"pass 2 launched the sparse volume kernel {odo_volume_launches} "
                                 f"times for {chunks} chunks of {n_rematch} re-matches")
        ate = float(run.ate.rmse)
        bound = ATE_FACTOR * JAX_SYNTHETIC_ATE + ATE_SLACK
        phase("main", f"{t} scans: odometry {run.seconds:.3f}s ({t / run.seconds:.1f} scans/s), "
                      f"cli total {wall:.2f}s; K1 chain launches {chain_launches}, batch-entry "
                      f"launches {step_launches}; pass-2 re-matches {n_rematch}, sparse volume "
                      f"kernel launches {odo_volume_launches}; switched "
                      f"{int(res.switched.sum())} weak {int(res.weak.sum())} "
                      f"discarded {int(res.discarded.sum())} fracture {int(res.fracture.sum())}; "
                      f"ATE {ate:.4f} m (JAX {JAX_SYNTHETIC_ATE:.4f}, bound {bound:.4f}); "
                      f"RPE {float(run.rpe[0].mean()):.4f} m; map {tuple(run.grid.log_odds.shape)}")
        if not ate <= bound:
            raise AssertionError(f"ATE {ate} above {bound}")

        # The pairwise path: K1's batch entry, one launch over the whole log.
        K.match_psm_fused.launches = K.odometry_chain_fused.launches = 0
        pw = cli.main(["odometry", log_path, "--device", "cuda", "--pairwise"])
        torch.cuda.synchronize()
        batch_launches = K.match_psm_fused.launches
        pw_poses = pw.result.poses.cpu().numpy()
        if batch_launches != 1 or K.odometry_chain_fused.launches != 0:
            raise AssertionError(f"pairwise odometry launched K1's batch entry {batch_launches} times")
        if pw_poses.shape != (t, 3) or not np.isfinite(pw_poses).all():
            raise AssertionError(f"bad pairwise trajectory: shape {pw_poses.shape}")
        phase("main", f"pairwise: {t} scans in {pw.seconds:.3f}s, K1 batch-entry launches "
                      f"{batch_launches}, ATE {float(pw.ate.rmse):.4f} m, "
                      f"failed pairs {int(pw.result.discarded.sum())}")

        # The step-loop route on the card, the chain entry's plain version:
        # its K1 inputs are kept (references only: each step builds them
        # anew); the call itself goes to the wrapper unchanged.
        fused, step_inputs = K.match_psm_fused, []

        def recording(model, ref, cur, init_pose=None, error_ref=None):
            step_inputs.append((ref, cur, init_pose, error_ref))
            return fused(model, ref, cur, init_pose, error_ref)

        odometry.match_psm_fused = recording
        try:
            steps_res, steps_s = host_s(lambda: odometry.odometry_keyframe(
                lms211, run.scans, timestamps=log.timestamps, chain="steps"))
        finally:
            odometry.match_psm_fused = fused
        if len(step_inputs) != t - 1:
            raise AssertionError(f"{len(step_inputs)} keyframe steps recorded for {t - 1}")
        for name_ in ("switched", "discarded", "weak", "fracture", "rematched"):
            if not torch.equal(getattr(res, name_), getattr(steps_res, name_)):
                raise AssertionError(f"chain entry and step loop differ in {name_}")
        chain_err = float((res.poses - steps_res.poses).abs().max())
        phase("parity", f"chain entry vs step loop, {t} scans: five flag arrays identical, "
                        f"max |dpose| {chain_err:.3g} (step loop {steps_s:.2f}s)")
        if not chain_err <= CHAIN_ATOL:
            raise AssertionError(f"chain entry and step loop differ by {chain_err}")

        # K1's batch entry and epilogue against the plain versions on the
        # keyframe steps' own inputs: two pairs per call, the keyframe pair
        # from its nonzero prior, the error index against the previous scan.
        sample = [c for c in step_inputs[STEP_SAMPLE - 1::STEP_SAMPLE]
                  if bool(c[2][0].abs().sum() > 0)]
        if len(sample) < (t - 1) // STEP_SAMPLE // 2:
            raise AssertionError(f"only {len(sample)} sampled steps have a nonzero prior")
        got = [K.match_psm_fused(lms211, *c) for c in sample]
        label = f"{lms211.name} {len(sample)} keyframe steps x2 pairs, nonzero prior, plain on cuda"
        k_steps = cat_results([g[0] for g in got], psm)
        stats.append(parity(
            k_steps, cat_results([psm.match_psm(lms211, *c[:3]) for c in sample], psm), label))
        stats[-1]["index_rel_err"] = index_parity(
            [torch.cat(x) for x in zip(*(g[1] for g in got))],
            [torch.cat(x) for x in zip(*(psm.error_index(lms211, c[3], c[1], g[0].pose)
                                         for c, g in zip(sample, got)))], label)
        step = sample[len(sample) // 2]
        step_ms = cuda_ms(lambda: K.match_psm_fused(lms211, *step), 200)
        step_plain_ms = cuda_ms(lambda: (
            psm.error_index(lms211, step[3], step[1], psm.match_psm(lms211, *step[:3]).pose)), 20)
        step_iters = int(K.match_psm_fused.last_iters.sum())
        step_bound, step_bound_by = bound_ms(
            lms211, step_iters, 2,
            n_bytes(step[0].ranges, step[0].bad, step[1].ranges, step[1].bad, step[3].ranges,
                    step[3].bad) + 2 * (MATCH_IO_BYTES + INDEX_OUT_BYTES))
        phase("timing", f"keyframe step (2 pairs, {step_iters} iterations, with the error "
                        f"index): K1 batch entry {step_ms:.4f} ms a call (wrapper's mask and "
                        f"output tensors included), plain {step_plain_ms:.3f} ms, "
                        f"bound {step_bound:.6f} ms by {step_bound_by}; {smi}")

        # The chain entry alone, the whole log in one launch.
        def chain():
            return K.odometry_chain_fused(lms211, run.scans, odometry.KEYFRAME_ERR_THRESH,
                                          2.0 * odometry.KEYFRAME_ERR_THRESH)

        chain_ms = cuda_ms(chain, 5)
        chain_plain_ms = cuda_ms(lambda: odometry._chain_steps(lms211, run.scans), 1)
        chain_bound, chain_bound_by = bound_ms(
            lms211, int(chain_iters.sum()), 2 * (t - 1),
            n_bytes(run.scans.ranges, run.scans.bad, run.scans.bad)
            + (t - 1) * CHAIN_STEP_OUT_BYTES)
        phase("timing", f"K1 chain entry, {t - 1} steps ({int(chain_iters.sum())} iterations in "
                        f"all, mean {chain_iters.mean():.2f} a match): {chain_ms:.3f} ms "
                        f"({chain_ms / (t - 1) * 1e3:.2f} us a step), step loop "
                        f"{chain_plain_ms:.1f} ms, bound {chain_bound:.5f} ms by "
                        f"{chain_bound_by}; {smi}")
        walls = [host_s(lambda: odometry.odometry_keyframe(
            lms211, run.scans, timestamps=log.timestamps))[1] for _ in range(3)]
        phase("timing", f"odometry_keyframe wall, 3 more runs: "
                        f"{', '.join(f'{x:.4f}' for x in walls)} s")

        # -- the device's view: profiler traces of the keyframe odometry and,
        # for K1's device time at a keyframe step, of 300 steps of the step loop
        traced_wall, n_ops, busy, by_name = trace(lambda: odometry.odometry_keyframe(
            lms211, run.scans, timestamps=log.timestamps))
        first = S.Scan(*(x[:301] for x in run.scans))
        _, step_ops, _, step_by_name = trace(lambda: odometry._chain_steps(lms211, first))
        step_n, step_dev_s = step_by_name.get("psm_match_kernel", (0, 0.0))
        if step_n != 300:
            raise AssertionError(f"the step loop launched K1 {step_n} times in 300 steps")
        step_device_ms = step_dev_s / step_n * 1e3
        phase("trace", json.dumps({
            "traced_wall_s": traced_wall, "untraced_wall_s": min(walls),
            "device_ops": n_ops, "device_busy_s": busy,
            "idle_share_of_traced_wall": 1.0 - busy / traced_wall,
            "by_kernel": {k: {"count": v[0], "seconds": v[1]} for k, v in by_name.items()},
            "step_loop_300_steps": {"device_ops_per_step": step_ops / 300,
                                    "k1_device_ms_per_step": step_device_ms},
            "card": smi}))
        if by_name.get("psm_chain_kernel", (0, 0.0))[0] != 1 or "psm_match_kernel" in by_name:
            raise AssertionError(f"pass 1 is not one chain kernel in the trace: {by_name}")
        if by_name.get("corr_volume_kernel", (0, 0.0))[0] != chunks:
            raise AssertionError(f"pass 2 is not {chunks} sparse volume kernels in the trace: "
                                 f"{by_name}")

        # -- where the main path's time goes: each layer again, alone ------
        _, t_read = host_s(lambda: read_carmen(log_path))
        _, t_pre = host_s(lambda: pp.preprocess(torch.as_tensor(log.ranges, device=dev), lms211))
        # Pass 2: the ±π correlative re-match of the flagged steps.
        steps = torch.as_tensor(np.nonzero(res.rematched.cpu().numpy())[0], device=dev)
        _, t_corr = host_s(lambda: correlative.match_correlative(
            lms211, S.Scan(*(x[steps - 1] for x in run.scans)),
            S.Scan(*(x[steps] for x in run.scans)), search_xy=1.2, n_theta=72))
        gt_t = torch.as_tensor(log.gt_pose, device=dev)
        _, t_metrics = host_s(lambda: (metrics.ate(res.poses, gt_t), metrics.rpe(res.poses, gt_t)))
        _, t_map = host_s(lambda: occ.integrate_scans(
            occ.empty_grid(run.grid.spec, device=dev), lms211, run.scans, res.poses))
        phase("layers", json.dumps({
            "read_s": t_read, "preprocess_s": t_pre, "odometry_s": run.seconds,
            "pass1_chain_s": chain_ms / 1e3, "correlative_rematch_s": t_corr,
            "odometry_other_s": run.seconds - chain_ms / 1e3 - t_corr,
            "steps_route_odometry_s": steps_s, "steps_route_pass1_s": chain_plain_ms / 1e3,
            "ate_rpe_s": t_metrics, "map_s": t_map, "card": smi}))

        # -- 5. the SLAM main path -------------------------------------------
        with search_calls() as searches:
            slam_chain_launches, slam_diag, slam_volume_launches = slam_phase(
                cli, K, log_path, log, smi)
        search_launches = {"cli_odometry": odo_search_launches,
                           "cli_slam": check_search_launches(searches, "[slam]")}

        # -- 6. the online path ------------------------------------------------
        with search_calls() as searches:
            online_launches, online_volume_launches, online_b1_diff = online_phase(
                K, log, smi, stats, psm, odometry, tmp.name)
        search_launches["online"] = check_search_launches(searches, "[online]")

        # -- 7. localization -----------------------------------------------------
        march = localize_phase(cli, log_path, log, smi)

        # -- 8.-11. the distributed topology, the other matchers and verifiers --
        V.score_volume_sparse.launches = 0
        with search_calls() as searches:
            tcp_launches = tcp_phase(cli, K, log_path, log, smi, tmp.name)
        search_launches["tcp_client"] = check_search_launches(searches, "[tcp] client")
        tcp_volume_launches = V.score_volume_sparse.launches
        matchers_phase(log, scans, smi)
        slam_icp_phase(log, smi)
        features_phase(log, smi)

        # -- 12. the robot application path --------------------------------------
        V.score_volume_sparse.launches = RK.ray_march.launches = 0
        with search_calls() as searches:
            robot_launches = robot_phase(K, log, smi, tmp.name)
        search_launches["robot"] = check_search_launches(searches, "[robot]")
        robot_volume_launches = V.score_volume_sparse.launches
        robot_march_launches = RK.ray_march.launches
        phase("localize", "nearest-two kernel launches by path (one a search, no search on the "
                          "plain block): " + json.dumps(search_launches))

        # -- 13. the Kalman and landmark filters ------------------------------------
        fusion_phase(smi)

        # -- 14. parallel/ on a one-rank NCCL group ----------------------------------
        parallel_launches = parallel_phase(K, log, scans, res.poses.cpu().numpy(), slam_diag, smi,
                                           tmp.name)

    # Small input against the plain version on the CPU: the first 300
    # pairs. Float transcendentals differ between the two devices in the
    # last bit, which can flip which pair covers a bin at a segment end in
    # the first (zero-pose) projection; the match then settles a few mm
    # apart, so the bounds are the parity bounds, not float round-off.
    a, b = pairs(S.Scan(*(x[:301] for x in scans)), S)
    cross_device_parity(K.match_psm_fused(lms211, a, b),
                        psm.match_psm(lms211, a.to("cpu"), b.to("cpu")),
                        f"{lms211.name} x300, plain on cpu")

    # -- 15. the bundled logs, when present ---------------------------------
    for name_, recorded in REFERENCE_ODOMETRY_ATE.items():
        path = Path(REFERENCE_DATA, f"{name_}.log")
        if not path.exists():
            phase(name_, f"{path} not present; skipped")
            continue
        run = cli.main(["odometry", str(path), "--device", "cuda"])
        ate = float(run.ate.rmse)
        phase(name_, f"{run.log.n_scans} scans: ATE {ate:.4f} m (recorded {recorded} x {ATE_FACTOR})")
        if not ate < recorded * ATE_FACTOR:
            raise AssertionError(f"{name_} odometry ATE {ate}")

    source = "laser_slam_tpu_torch/csrc/psm_kernel.cu"
    replaces = "laser_slam_tpu/ops/pallas/psm_kernel.py:341"
    record = {"kernels": [
        {
            "name": "psm_chain_kernel (K1, keyframe chain entry: pass 1 of a whole log)",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": chain_launches, "launches_cli_slam": slam_chain_launches,
            "max_abs_err": chain_err,
            "ms": chain_ms, "plain_ms": chain_plain_ms,
            "bound_ms": chain_bound, "bound_by": chain_bound_by,
            "library_ms": None,
            "steps": t - 1, "us_per_step": chain_ms / (t - 1) * 1e3,
        },
        {
            "name": "psm_match_kernel (K1, batch entry: one block per pair)",
            "route": "cuda", "source": source, "replaces": replaces,
            "launches": (batch_launches + online_launches + tcp_launches + robot_launches
                         + parallel_launches),
            "launches_pairwise": batch_launches, "launches_online": online_launches,
            "launches_tcp": tcp_launches, "launches_robot": robot_launches,
            "launches_parallel": parallel_launches,
            "launches_cli_slam": 0,
            "max_abs_err": max(s["max_abs_err"] for s in stats),
            "ms": batch_ms, "plain_ms": batch_plain_ms,
            "bound_ms": batch_bound, "bound_by": batch_bound_by,
            "library_ms": None,
            "batch_pairs": n_pairs, "with_index_ms": batch_index_ms,
            "step_pairs": 2, "step_ms": step_ms, "step_device_ms": step_device_ms,
            "step_plain_ms": step_plain_ms, "step_bound_ms": step_bound,
            "index_max_rel_err": max(s["index_rel_err"] for s in stats),
        },
        {
            "name": "corr_volume_kernel (sparse correlative score volume: pass 2 at 128 rows x 72 "
                    "rotations x 529 shifts on a 256^2 grid, 181 beams; 361 beams under _361)",
            "route": "cuda", "source": "laser_slam_tpu_torch/csrc/correlative_kernel.cu",
            "replaces": None,
            "launches": (odo_volume_launches + slam_volume_launches + online_volume_launches
                         + tcp_volume_launches + robot_volume_launches),
            "launches_cli_odometry": odo_volume_launches,
            "launches_cli_slam": slam_volume_launches, "launches_online": online_volume_launches,
            "launches_tcp_client": tcp_volume_launches, "launches_robot": robot_volume_launches,
            "max_abs_err": 0.0, "max_abs_err_b1_online": online_b1_diff,
            **corr[181], **{f"{k}_361": v for k, v in corr[361].items()},
        },
        {**march, "launches": march["launches_localize_cli"] + march["launches_update_beam"]
         + robot_march_launches, "launches_robot": robot_march_launches},
        {**nearest_two_phase(smi), "launches": sum(search_launches.values()),
         **{f"launches_{k}": v for k, v in search_launches.items()},
         **{f"pass2_{k}_{n}": v for n, e in pass2_search.items() for k, v in e.items()}},
    ]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
