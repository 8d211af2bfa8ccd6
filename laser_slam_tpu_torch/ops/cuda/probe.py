"""Probes of the port's CUDA kernels on a CUDA card, for tuning them.

Run from a checkout (it takes its pairs from ``tools/synthetic_log.py``):

    python -m laser_slam_tpu_torch.ops.cuda.probe phases
    python -m laser_slam_tpu_torch.ops.cuda.probe flags -- -fmad=false

- ``phases`` builds a copy of ``csrc/psm_kernel.cu`` with ``clock64()``
  counters around the phases of a solver iteration and prints the mean
  cycles of each, for the keyframe chain of the 2672-scan synthetic log,
  for its 2671 consecutive pairs as one batch, and for one batch of two
  pairs. The counters cost a few hundred cycles a match themselves.
- ``flags`` builds the kernel once as it is and once with the extra
  ``nvcc`` flags given, and prints how far each build's poses lie from
  the plain matcher's on the 2671 pairs, with the worst pairs.

Neither is part of the port's path: both install a rebuilt PSM kernel
library in place of the one the process uses, so run nothing else in
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

from ...core.scan import Scan
from .. import odometry, preprocess, psm
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
    src = K.KERNEL.source.read_text()
    for anchor, new in _COUNTERS:
        if src.count(anchor) != 1:
            raise RuntimeError(
                f"probe: anchor not found exactly once in {K.KERNEL.source}: {anchor!r}")
        src = src.replace(anchor, new)
    return src


def _install(source: Path, flags: tuple, extra: dict | None = None) -> nvcc.Kernel:
    """K1 built from ``source`` with ``flags``, its entries and ``extra``
    ones declared, and installed as the library K1's operators launch."""
    kernel = nvcc.Kernel(source, {**K.KERNEL.signatures, **(extra or {})}, K.KERNEL.error_string)
    kernel.build(flags)
    K.KERNEL.install(kernel)
    return kernel


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
    cycles = _install(copy, nvcc.NVCC_FLAGS, {"psm_cycles_read": [ctypes.c_void_p]})
    buf = (ctypes.c_ulonglong * 8)()

    def report(label: str) -> None:
        cycles.lib.psm_cycles_read(ctypes.cast(buf, ctypes.c_void_p))
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
    base = nvcc.NVCC_FLAGS
    for label, fl in (("as built", base), (" ".join(extra), (*extra, *base))):
        _install(K.KERNEL.source, fl)
        got = K.match_psm_fused(model, ref, cur)
        d = (got.pose - plain.pose).abs().max(dim=1).values.cpu().numpy()
        worst = np.argsort(-d)[:3]
        print(f"[{label}] max |dpose| {d.max():.3g}, pairs above 1e-5: {int((d > 1e-5).sum())}, "
              f"fail mismatches {int((got.fail != plain.fail).sum())}; worst "
              + ", ".join(f"pair {i}: {d[i]:.3g}" for i in worst))


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
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main()
