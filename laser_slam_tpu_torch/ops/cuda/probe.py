"""Probes of the port's CUDA kernels on a CUDA card, for tuning them.

Run from a checkout (it takes its pairs from ``tools/synthetic_log.py``):

    python -m laser_slam_tpu_torch.ops.cuda.probe phases
    python -m laser_slam_tpu_torch.ops.cuda.probe flags -- -fmad=false
    python -m laser_slam_tpu_torch.ops.cuda.probe volume

- ``phases`` builds a copy of ``csrc/psm_kernel.cu`` with ``clock64()``
  counters around the phases of a solver iteration and prints the mean
  cycles of each, for the keyframe chain of the 2672-scan synthetic log,
  for its 2671 consecutive pairs as one batch, and for one batch of two
  pairs. The counters cost a few hundred cycles a match themselves.
- ``flags`` builds the kernel once as it is and once with the extra
  ``nvcc`` flags given, and prints how far each build's poses lie from
  the plain matcher's on the 2671 pairs, with the worst pairs.
- ``volume`` times the sparse correlative score-volume kernel
  (``csrc/correlative_kernel.cu``) and its plain version, the grouped
  conv, at the keyframe odometry's pass-2 shapes (128 consecutive pairs
  of the synthetic trajectory, 72 rotations, ±1.2 m) at 181 and 361
  beams, with CUDA events; prints whether the two volumes are equal bit
  for bit, each one's peak memory, and the kernel's least time on the
  card.

``phases`` and ``flags`` are not part of the port's path: both rebuild
the PSM kernel library that the process uses, so run nothing else in
that process.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from ...core.scan import PRESETS, Scan
from .. import correlative, odometry, preprocess, psm
from ..icp_points import scan_to_points
from . import correlative_kernel as V
from . import nvcc
from . import psm_kernel as K

PHASES = ("projection 1", "orientation sums", "argmin and update", "projection 2",
          "translation", "epilogue")

# (anchor in the source, replacement): each anchor must occur exactly once.
_COUNTERS = (
    ("namespace {\n\nconstexpr int kMaxBeams",
     "__device__ unsigned long long g_cycles[8];\nnamespace {\n"
     "#define TICK(k) { long long c_ = clock64(); cyc[k] += c_ - c0; c0 = c_; }\n\n"
     "constexpr int kMaxBeams"),
    ("  bool fail = false, done = false;\n",
     "  bool fail = false, done = false;\n"
     "  long long cyc[6] = {0, 0, 0, 0, 0, 0}; long long c0 = clock64();\n"),
    ("    project(w, p, t, cur_r, cur_ok, ax, ay, ath, true, nr, nbad);\n",
     "    project(w, p, t, cur_r, cur_ok, ax, ay, ath, true, nr, nbad);\n    TICK(0)\n"),
    ("    __syncthreads();\n    // Every warp alike",
     "    __syncthreads();\n    TICK(1)\n    // Every warp alike"),
    ("    // -- translation half-step --\n", "    TICK(2)\n    // -- translation half-step --\n"),
    ("    project(w, p, t, cur_r, cur_ok, ax, ay, ath, false, nr, nbad);\n    float v[kSums]",
     "    project(w, p, t, cur_r, cur_ok, ax, ay, ath, false, nr, nbad);\n    TICK(3)\n"
     "    float v[kSums]"),
    ("      done = fail || small >= 3;\n    }\n",
     "      done = fail || small >= 3;\n    }\n    TICK(4)\n"),
    ("  return out;\n}\n\n__device__ __forceinline__ Thread make_thread",
     "  TICK(5)\n  if (tid == 0) {\n"
     "    for (int k = 0; k < 6; ++k) atomicAdd(&g_cycles[k], (unsigned long long)cyc[k]);\n"
     "    atomicAdd(&g_cycles[6], (unsigned long long)iters);\n"
     "    atomicAdd(&g_cycles[7], 1ull);\n  }\n"
     "  return out;\n}\n\n__device__ __forceinline__ Thread make_thread"),
    ("const char* psm_error_string",
     "int psm_cycles_read(unsigned long long* out) {\n"
     "  cudaDeviceSynchronize();\n"
     "  cudaMemcpyFromSymbol(out, g_cycles, sizeof(unsigned long long) * 8);\n"
     "  unsigned long long zero[8] = {0};\n"
     "  cudaMemcpyToSymbol(g_cycles, zero, sizeof(zero));\n  return 0;\n}\n\n"
     "const char* psm_error_string"),
)


def instrumented_source() -> str:
    """The kernel source with the cycle counters added."""
    src = K.SOURCE.read_text()
    for anchor, new in _COUNTERS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe: anchor not found exactly once in {K.SOURCE}: {anchor!r}")
        src = src.replace(anchor, new)
    return src


def _rebuild(source: Path, flags: tuple) -> None:
    K.SOURCE, K._lib = source, None
    K.build(flags)


def _log_on_card():
    """The synthetic log, written and read back as a CARMEN file: its
    model and its preprocessed scans on the card."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[3] / "tools"))
    import synthetic_log as synth

    from ...io.carmen import read_carmen

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic.log")
        synth.write_carmen(path, *synth.synthetic_log())
        log = read_carmen(path)
    scans = preprocess.preprocess(torch.as_tensor(log.ranges, device="cuda"), log.model)
    return log.model, scans


def phases() -> None:
    model, scans = _log_on_card()
    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    copy = nvcc.BUILD_DIR / "psm_kernel_cycles.cu"
    copy.write_text(instrumented_source())
    _rebuild(copy, nvcc.NVCC_FLAGS)
    K._lib.psm_cycles_read.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_ulonglong * 8)()

    def report(label: str) -> None:
        K._lib.psm_cycles_read(ctypes.cast(buf, ctypes.c_void_p))
        v = list(buf)
        iters, matches = max(v[6], 1), max(v[7], 1)
        per = {n: v[k] / (matches if n == "epilogue" else iters) for k, n in enumerate(PHASES)}
        print(f"{label}: {matches} matches, {iters} iterations; cycles an iteration "
              f"{sum(v[:5]) / iters:.0f}; " + ", ".join(f"{n} {c:.0f}" for n, c in per.items())
              + " (epilogue: a match)")

    ref, cur = Scan(*(x[:-1] for x in scans)), Scan(*(x[1:] for x in scans))
    K.odometry_chain_fused(model, scans, odometry.KEYFRAME_ERR_THRESH,
                           2.0 * odometry.KEYFRAME_ERR_THRESH)
    report("keyframe chain")
    K.match_psm_fused(model, ref, cur, error_ref=ref)
    report(f"batch of {ref.ranges.shape[0]}")
    two = lambda s: Scan(*(x[100:102] for x in s))
    K.match_psm_fused(model, two(ref), two(cur), error_ref=two(ref))
    report("batch of 2")


def flags(extra: list[str]) -> None:
    model, scans = _log_on_card()
    ref, cur = Scan(*(x[:-1] for x in scans)), Scan(*(x[1:] for x in scans))
    plain = psm.match_psm(model, ref, cur)
    source, base = K.SOURCE, nvcc.NVCC_FLAGS
    for label, fl in (("as built", base), (" ".join(extra), (*extra, *base))):
        _rebuild(source, fl)
        got = K.match_psm_fused(model, ref, cur)
        d = (got.pose - plain.pose).abs().max(dim=1).values.cpu().numpy()
        worst = np.argsort(-d)[:3]
        print(f"[{label}] max |dpose| {d.max():.3g}, pairs above 1e-5: {int((d > 1e-5).sum())}, "
              f"fail mismatches {int((got.fail != plain.fail).sum())}; worst "
              + ", ".join(f"pair {i}: {d[i]:.3g}" for i in worst))


def _elapsed_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after two warm-ups."""
    fn(), fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _peak_bytes(fn) -> int:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def volume() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[3] / "tools"))
    import synthetic_log as synth

    seconds = V.build()
    print(f"build {seconds:.2f} s: " + " | ".join(
        line.strip() for line in V.build_log.splitlines() if "Used" in line or "spill" in line))
    dev = torch.device("cuda")
    rows, k_rot = 128, 72
    n_steps = int(1.2 / correlative.GRID_RES)          # match_correlative's window
    t = 2 * n_steps + 1
    gt, _ = synth.trajectory(rows + 1)
    rng = np.random.default_rng(0)
    for name in ("LMS211", "LMS511"):
        model = PRESETS[name]
        r = synth.ray_cast(synth.floor_plan(), gt, model.bearings(torch.float64).numpy())
        r = np.where(r <= synth.MAX_RANGE, r + rng.normal(0.0, synth.NOISE, r.shape), r)
        scans = preprocess.preprocess(torch.as_tensor(r.astype(np.float32), device=dev), model)
        ref, cur = Scan(*(x[:-1] for x in scans)), Scan(*(x[1:] for x in scans))
        grid = correlative.build_likelihood_grid(model, ref)
        pts, ok = scan_to_points(model, cur)
        thetas = correlative._linspace(-np.pi, np.pi, k_rot, torch.float32, dev)
        thetas = thetas.expand(rows, k_rot).contiguous()
        base = torch.zeros(rows, 2, device=dev)
        g = grid.shape[-1]
        ix, iy, inb = correlative._rotated_cells(
            pts, ok, thetas, base, correlative.GRID_RES, correlative.GRID_HALF_EXTENT, g)
        cells = torch.where(inb, iy * g + ix, -1).to(torch.int32)
        planes = grid[None]
        plane = torch.arange(rows * k_rot, device=dev).view(rows, k_rot, 1) * (g * g)
        raster = torch.zeros(rows * k_rot * g * g, device=dev).index_add_(
            0, torch.where(inb, plane + iy * g + ix, 0).reshape(-1),
            inb.float().reshape(-1)).view(rows * k_rot, 1, g, g)
        pad = torch.nn.functional.pad(planes, (n_steps,) * 4)

        got = V.score_volume_sparse(planes, cells, n_steps)
        want = correlative._score_volume_conv(planes, ix, iy, inb, n_steps)
        equal = torch.equal(got, want)
        diff = float((got - want).abs().max())
        same_arg = torch.equal(got.flatten(2).argmax(-1), want.flatten(2).argmax(-1))
        ms_kernel = _elapsed_ms(lambda: V.score_volume_sparse(planes, cells, n_steps), 50)
        ms_conv = _elapsed_ms(lambda: correlative._conv2d(pad, raster, rows), 5)
        ms_plain = _elapsed_ms(
            lambda: correlative._score_volume_conv(planes, ix, iy, inb, n_steps), 5)
        mb_kernel = _peak_bytes(lambda: V.score_volume_sparse(planes, cells, n_steps)) / 1e6
        mb_plain = _peak_bytes(
            lambda: correlative._score_volume_conv(planes, ix, iy, inb, n_steps)) / 1e6
        n_valid = inb.sum(-1).float()                  # points on the raster, a block
        blocks = cells.view(-1, cells.shape[-1])[::97]
        uniq = torch.tensor([len(torch.unique(c[c >= 0])) for c in blocks])
        most = rows * k_rot * model.n_beams * t * t    # multiply-adds, every beam valid
        need = float(n_valid.sum()) * t * t            # multiply-adds of these inputs
        byts = (planes.numel() + got.numel()) * 4 + cells.numel() * 4
        print(f"{name} ({model.n_beams} beams), B={rows} K={k_rot} T={t} G={g}: equal {equal}, "
              f"max |d| {diff:.3g}, argmax equal {same_arg}; points on the raster a block "
              f"mean {float(n_valid.mean()):.1f} max {int(n_valid.max())}, unique cells "
              f"(every 97th block) mean {float(uniq.float().mean()):.1f}")
        print(f"  kernel {ms_kernel:.4f} ms, conv alone {ms_conv:.3f} ms, plain version "
              f"(raster, pad, conv) {ms_plain:.3f} ms; peak memory kernel {mb_kernel:.1f} MB, "
              f"plain {mb_plain:.1f} MB")
        print(f"  bound: {2 * most / 67e12 * 1e3:.4f} ms at {most:.3g} multiply-adds (every beam), "
              f"{2 * need / 67e12 * 1e3:.4f} ms at {need:.3g} (these inputs), bytes "
              f"{byts / 3.35e12 * 1e3:.4f} ms ({byts / 1e6:.1f} MB)")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("probe: needs a CUDA device")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    if argv[:1] == ["phases"]:
        phases()
    elif argv[:1] == ["flags"] and len(argv) > 1:
        flags([a for a in argv[1:] if a != "--"])
    elif argv[:1] == ["volume"]:
        volume()
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
