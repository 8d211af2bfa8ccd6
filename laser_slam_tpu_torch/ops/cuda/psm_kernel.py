"""Host wrapper of the fused PSM CUDA kernel (``csrc/psm_kernel.cu``).

The kernel replaces the Pallas TPU kernel
``laser_slam_tpu/ops/pallas/psm_kernel.py::match_psm_pallas`` and
computes the function of the plain :func:`..psm.match_psm`: one block
per pair runs the whole match with a true per-pair early exit.

The source is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` beside the package at first use (keyed by a hash of
the source and flags) and loaded with ``ctypes``. CPU tensors take the
plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from ...core import se2
from ...core.scan import LaserModel, Scan
from .. import psm
from ..project import _pair_valid_from_seg

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "psm_kernel.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
MAX_BEAMS = 544

_lib = None
build_log = ""   # nvcc's output (ptxas register / shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the PSM kernel needs the CUDA toolkit")


def build() -> float:
    """Compile (if needed) and load the kernel library; returns the
    seconds spent, 0 when it was already loaded."""
    global _lib, build_log
    if _lib is not None:
        return 0.0
    t0 = time.perf_counter()
    src = SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"psm_kernel_{digest}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True,
        )
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {SOURCE}:\n{build_log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.psm_match_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, vp, vp,   # tensors
        ci, ci, ci, cf, cf, cf, cf, ci, ci, ci, ci,
        vp,                                    # stream
    ]
    lib.psm_match_launch.restype = ci
    lib.psm_error_string.argtypes = [ci]
    lib.psm_error_string.restype = ctypes.c_char_p
    _lib = lib
    return time.perf_counter() - t0


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"match_psm_fused: {name} must be a contiguous {dtype} tensor of "
            f"shape {tuple(shape)}, got {t.dtype} {tuple(t.shape)}"
        )


def match_psm_fused(
    model: LaserModel, ref: Scan, cur: Scan, init_pose: torch.Tensor | None = None
) -> psm.MatchResult:
    """Batched PSM match of ``cur`` against ``ref`` (``[B, N]`` scans),
    ``init_pose [B, 3]``; the function of :func:`..psm.match_psm`.

    CPU inputs run the plain version; CUDA inputs launch the kernel
    (counted in ``match_psm_fused.launches``) or raise.
    """
    dev = cur.ranges.device
    if dev.type == "cpu":
        return psm.match_psm(model, ref, cur, init_pose)
    if dev.type != "cuda":
        raise ValueError(f"match_psm_fused: unsupported device {dev}")
    if cur.ranges.dim() != 2:
        raise ValueError("match_psm_fused: scans must be [B, N]")
    b, n = cur.ranges.shape
    if n != model.n_beams or n > MAX_BEAMS:
        raise ValueError(f"match_psm_fused: {n} beams (model {model.n_beams}, max {MAX_BEAMS})")
    for name, t in (("ref", ref), ("cur", cur)):
        if any(x.device != dev for x in t):
            raise ValueError(f"match_psm_fused: {name} is not on {dev}")
    if init_pose is None:
        init_pose = torch.zeros(b, 3, dtype=torch.float32, device=dev)
    _check("ref.ranges", ref.ranges, torch.float32, (b, n))
    _check("ref.bad", ref.bad, torch.bool, (b, n))
    _check("cur.ranges", cur.ranges, torch.float32, (b, n))
    _check("init_pose", init_pose, torch.float32, (b, 3))
    if init_pose.device != dev:
        raise ValueError(f"match_psm_fused: init_pose is not on {dev}")

    build()
    pair_ok = _pair_valid_from_seg(cur).contiguous()
    fi = model.bearings(torch.float32, dev)
    pose = torch.empty(b, 3, dtype=torch.float32, device=dev)
    err = torch.empty(b, dtype=torch.float32, device=dev)
    fail = torch.empty(b, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    device_index = dev.index if dev.index is not None else torch.cuda.current_device()
    rc = _lib.psm_match_launch(
        ref.ranges.data_ptr(), ref.bad.data_ptr(), cur.ranges.data_ptr(),
        pair_ok.data_ptr(), fi.data_ptr(), init_pose.data_ptr(),
        pose.data_ptr(), err.data_ptr(), fail.data_ptr(),
        b, n, model.window, model.dfi, model.min_range, model.max_range,
        psm.WEIGHTING_FACTOR, model.min_valid_points, psm.MAX_ITER // 2,
        psm.CHANGE_WEIGHT_ITER // 2, device_index, stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"PSM kernel launch failed: {_lib.psm_error_string(rc).decode()}"
        )
    match_psm_fused.launches += 1
    pose[:, 2] = se2.normalize_angle(pose[:, 2])
    return psm.MatchResult(
        pose=pose, err=err, fail=fail,
        n_valid=torch.zeros(b, dtype=torch.int32, device=dev),
    )


match_psm_fused.launches = 0
