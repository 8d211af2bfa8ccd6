"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. device — require CUDA; print the card and its power limit;
2. build — compile the fused PSM kernel (K1) from ``laser_slam_tpu_torch/
   csrc`` with nvcc for sm_90a;
3. kernel parity at full size — K1 against the plain PyTorch matcher on
   the card: 2671 consecutive LMS211 pairs of the synthetic intel-lab-
   shaped log, and 512 pairs at 361 and 541 beams; batch timings;
4. main path — ``laser_slam_tpu_torch.cli odometry`` on the 2672-scan
   synthetic CARMEN log on ``cuda``: read → preprocess → keyframe
   odometry (K1 two pairs per step, ±π correlative re-match of flagged
   steps) → ATE/RPE → occupancy map → PNG; then K1 against the plain
   matcher on the keyframe steps' own two-pair inputs (with their
   nonzero priors), the step timing, and each layer of the path again,
   alone, for its share of the time;
5. the bundled intel-lab log, when present at the repo's reference-data
   location (``REFERENCE_DATA``, as in ``tests/conftest.py``).

The last two lines of stdout are the kernels' JSON record and the
device JSON line.
"""

from __future__ import annotations

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
# The bundled logs' location, as in tests/conftest.py, and the recorded
# keyframe-odometry ATE of the JAX package on intel-lab
# (tests/test_accuracy.py) with the regression factor applied there.
REFERENCE_DATA = "/root/reference/data"
INTEL_LOG = Path(REFERENCE_DATA, "intel-lab.log")
INTEL_ODOMETRY_ATE = 8.97
# K1 against the plain matcher on the same card: the same fail flags,
# every pose within 1e-4 (float32 op order: fused multiply-adds, block
# reductions) and every mean residual within rtol 1e-4, as in
# tests/test_torch_cuda.py.
POSE_ATOL, ERR_RTOL = 1e-4, 1e-4
# K1 on the card against the plain matcher on the CPU: the compiled-parity
# bounds of tests/test_pallas_psm.py::test_pallas_compiled_parity_on_intel,
# because float transcendentals differ between the devices in the last bit.
P50_T, P99_T, P50_R_DEG, P99_R_DEG, MAX_KERNEL_ONLY_FAILS = 5e-3, 0.15, 0.1, 2.0, 5
# Every this-many keyframe steps of the main path, K1 is held to the plain
# matcher on that step's own inputs.
STEP_SAMPLE = 16


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
    from laser_slam_tpu_torch.ops.cuda import psm_kernel as K
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
    t_build = K.build()
    ptxas = " | ".join(l.strip() for l in K.build_log.splitlines() if "Used" in l or "spill" in l)
    phase("build", f"K1 {K.SOURCE.relative_to(ROOT)} built in {t_build:.2f}s ({ptxas})")

    # -- 3. kernel parity and timing at full size ---------------------------
    tmp = tempfile.TemporaryDirectory()
    log_path = os.path.join(tmp.name, "synthetic.log")
    ranges, gt, ts = synth.synthetic_log()
    synth.write_carmen(log_path, ranges, gt, ts)
    log = read_carmen(log_path)
    lms211 = log.model
    scans = pp.preprocess(torch.as_tensor(log.ranges, device=dev), lms211)
    ref, cur = pairs(scans, S)
    stats = [parity(K.match_psm_fused(lms211, ref, cur), psm.match_psm(lms211, ref, cur),
                    f"{lms211.name} x{ref.ranges.shape[0]}, plain on cuda")]
    rng = np.random.default_rng(7)
    for model in (S.LMS511, S.LMS151):
        r = synth.ray_cast(synth.floor_plan(), gt[:513], model.bearings(torch.float64).numpy())
        r = np.where(r <= synth.MAX_RANGE, r + rng.normal(0.0, synth.NOISE, r.shape), r)
        a, b = pairs(pp.preprocess(torch.as_tensor(r.astype(np.float32), device=dev), model), S)
        stats.append(parity(K.match_psm_fused(model, a, b), psm.match_psm(model, a, b),
                            f"{model.name} x512, plain on cuda"))

    batch_ms = cuda_ms(lambda: K.match_psm_fused(lms211, ref, cur), 20)
    batch_plain_ms = cuda_ms(lambda: psm.match_psm(lms211, ref, cur), 3)
    n_pairs = ref.ranges.shape[0]
    phase("timing", f"K1 {n_pairs} pairs: {batch_ms:.3f} ms ({n_pairs / batch_ms * 1e3:.1f} "
                    f"matches/s), plain {batch_plain_ms:.3f} ms "
                    f"({n_pairs / batch_plain_ms * 1e3:.1f} matches/s); {smi}")

    # -- 4. main path -----------------------------------------------------
    # The keyframe step's K1 inputs are kept (references only: each step
    # builds them anew) so that K1 can be held to the plain matcher on them
    # after the run; the call itself goes to the wrapper unchanged.
    fused, step_inputs = K.match_psm_fused, []

    def recording(model, ref, cur, init_pose=None):
        step_inputs.append((ref, cur, init_pose))
        return fused(model, ref, cur, init_pose)

    with tmp:
        traj, png = os.path.join(tmp.name, "traj.txt"), os.path.join(tmp.name, "map.png")
        odometry.match_psm_fused = recording
        try:
            K.match_psm_fused.launches = 0
            t0 = time.perf_counter()
            run = cli.main(["odometry", log_path, "--device", "cuda", "--out", traj,
                            "--map", png])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = K.match_psm_fused.launches
        finally:
            odometry.match_psm_fused = fused
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
        if launches < t - 1:
            raise AssertionError(f"K1 launched {launches} times for {t - 1} steps")
        n_rematch = int(res.rematched.sum())
        if n_rematch <= 0:
            raise AssertionError("pass 2 (correlative re-match) never ran")
        ate = float(run.ate.rmse)
        bound = ATE_FACTOR * JAX_SYNTHETIC_ATE + ATE_SLACK
        phase("main", f"{t} scans: odometry {run.seconds:.2f}s ({t / run.seconds:.1f} scans/s), "
                      f"cli total {wall:.2f}s; K1 launches {launches}; pass-2 re-matches "
                      f"{n_rematch}; switched {int(res.switched.sum())} weak {int(res.weak.sum())} "
                      f"discarded {int(res.discarded.sum())} fracture {int(res.fracture.sum())}; "
                      f"ATE {ate:.4f} m (JAX {JAX_SYNTHETIC_ATE:.4f}, bound {bound:.4f}); "
                      f"RPE {float(run.rpe[0].mean()):.4f} m; map {tuple(run.grid.log_odds.shape)}")
        if not ate <= bound:
            raise AssertionError(f"ATE {ate} above {bound}")

        # K1 against the plain matcher on the keyframe steps' own inputs:
        # two pairs per call, the keyframe pair from its nonzero prior.
        if len(step_inputs) != t - 1:
            raise AssertionError(f"{len(step_inputs)} keyframe steps recorded for {t - 1}")
        sample = [c for c in step_inputs[STEP_SAMPLE - 1::STEP_SAMPLE]
                  if bool(c[2][0].abs().sum() > 0)]
        if len(sample) < (t - 1) // STEP_SAMPLE // 2:
            raise AssertionError(f"only {len(sample)} sampled steps have a nonzero prior")
        stats.append(parity(
            cat_results([K.match_psm_fused(lms211, *c) for c in sample], psm),
            cat_results([psm.match_psm(lms211, *c) for c in sample], psm),
            f"{lms211.name} {len(sample)} keyframe steps x2 pairs, nonzero prior, plain on cuda"))
        step = sample[len(sample) // 2]
        step_ms = cuda_ms(lambda: K.match_psm_fused(lms211, *step), 200)
        step_plain_ms = cuda_ms(lambda: psm.match_psm(lms211, *step), 20)
        phase("timing", f"keyframe step (2 pairs): K1 {step_ms:.4f} ms, "
                        f"plain {step_plain_ms:.3f} ms; {smi}")

        # -- where the main path's time goes: each layer again, alone ------
        _, t_read = host_s(lambda: read_carmen(log_path))
        _, t_pre = host_s(lambda: pp.preprocess(torch.as_tensor(log.ranges, device=dev), lms211))
        # The keyframe step's error indices: one call on two pairs, both
        # against the previous scan (row 1 of the step's reference pair).
        last2 = S.Scan(*(x[[1, 1]] for x in step[0]))
        pose2 = K.match_psm_fused(lms211, *step).pose
        ei_ms = cuda_ms(lambda: psm.error_index(lms211, last2, step[1], pose2), 200)
        # Pass 2: the ±π correlative re-match of the flagged steps.
        steps = torch.as_tensor(np.nonzero(res.rematched.cpu().numpy())[0], device=dev)
        _, t_corr = host_s(lambda: correlative.match_correlative(
            lms211, S.Scan(*(x[steps - 1] for x in run.scans)),
            S.Scan(*(x[steps] for x in run.scans)), search_xy=1.2, n_theta=72))
        gt_t = torch.as_tensor(log.gt_pose, device=dev)
        _, t_metrics = host_s(lambda: (metrics.ate(res.poses, gt_t), metrics.rpe(res.poses, gt_t)))
        _, t_map = host_s(lambda: occ.integrate_scans(
            occ.empty_grid(run.grid.spec, device=dev), lms211, run.scans, res.poses))
        k1_s, ei_s = launches * step_ms / 1e3, (t - 1) * ei_ms / 1e3
        phase("layers", json.dumps({
            "read_s": t_read, "preprocess_s": t_pre, "odometry_s": run.seconds,
            "k1_s": k1_s, "error_index_s": ei_s,
            "correlative_rematch_s": t_corr, "pass1_other_s": run.seconds - k1_s - ei_s - t_corr,
            "ate_rpe_s": t_metrics, "map_s": t_map, "card": smi}))

    # Small input against the plain version on the CPU: the first 300
    # pairs. Float transcendentals differ between the two devices in the
    # last bit, which can flip which pair covers a bin at a segment end in
    # the first (zero-pose) projection; the match then settles a few mm
    # apart, so the bounds are the parity bounds, not float round-off.
    a, b = pairs(S.Scan(*(x[:301] for x in scans)), S)
    cross_device_parity(K.match_psm_fused(lms211, a, b),
                        psm.match_psm(lms211, a.to("cpu"), b.to("cpu")),
                        f"{lms211.name} x300, plain on cpu")

    # -- 5. the bundled intel-lab log, when present -------------------------
    if INTEL_LOG.exists():
        run = cli.main(["odometry", str(INTEL_LOG), "--device", "cuda"])
        ate = float(run.ate.rmse)
        phase("intel-lab", f"{run.log.n_scans} scans: ATE {ate:.4f} m "
                           f"(recorded {INTEL_ODOMETRY_ATE} x {ATE_FACTOR})")
        if not ate < INTEL_ODOMETRY_ATE * ATE_FACTOR:
            raise AssertionError(f"intel-lab odometry ATE {ate}")
    else:
        phase("intel-lab", f"{INTEL_LOG} not present; skipped")

    record = {"kernels": [{
        "name": "psm_match (K1, fused PSM matcher)",
        "route": "cuda",
        "source": "laser_slam_tpu_torch/csrc/psm_kernel.cu",
        "replaces": "laser_slam_tpu/ops/pallas/psm_kernel.py:341",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in stats),
        "ms": step_ms,
        "plain_ms": step_plain_ms,
        "batch_pairs": n_pairs,
        "batch_ms": batch_ms,
        "batch_plain_ms": batch_plain_ms,
    }]}
    print(json.dumps(record))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
