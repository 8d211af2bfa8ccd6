"""Host wrappers of the fused PSM CUDA kernel (``csrc/psm_kernel.cu``).

The kernel replaces the Pallas TPU kernel
``laser_slam_tpu/ops/pallas/psm_kernel.py::match_psm_pallas`` and has
two entries over one set of device functions:

- :func:`match_psm_fused` — one block per pair runs the whole match of
  the plain :func:`..psm.match_psm` with a true per-pair early exit and,
  when asked, :func:`..psm.error_index` at the final pose as an epilogue;
- :func:`odometry_chain_fused` — pass 1 of the keyframe odometry for a
  whole log in one launch (the plain version is the loop of
  ``odometry._step``).

The source is compiled with ``nvcc`` for ``sm_90a`` into
``build/kernels/`` beside the package at first use (keyed by a hash of
the source and flags) and loaded with ``ctypes``. CPU tensors take the
plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import time

import torch

from ...core import se2
from ...core.scan import LaserModel, Scan
from .. import psm
from ..project import _pair_valid_from_seg
from . import nvcc

SOURCE = nvcc.PKG / "csrc" / "psm_kernel.cu"
MAX_BEAMS = 544

_lib = None
build_log = ""   # nvcc's output (ptxas register / shared-memory report)


def build(flags: tuple = nvcc.NVCC_FLAGS) -> float:
    """Compile (if needed, with ``nvcc`` ``flags``) and load the kernel
    library; returns the seconds spent, 0 when it was already loaded."""
    global _lib, build_log
    with nvcc.LOCK:
        if _lib is not None:
            return 0.0
        t0 = time.perf_counter()
        lib, build_log = nvcc.load(SOURCE, flags)
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        model_args = [ci, ci, cf, cf, cf, cf, ci, ci, ci]   # n ... change_weight_it
        lib.psm_match_launch.argtypes = [
            *[vp] * 15,            # tensors
            ci, *model_args,       # batch, model
            ci, vp,                # device, stream
        ]
        lib.psm_match_launch.restype = ci
        lib.psm_chain_launch.argtypes = [
            *[vp] * 9,             # tensors
            ci, *model_args,       # n_scans, model
            cf, cf,                # thresholds
            ci, vp,                # device, stream
        ]
        lib.psm_chain_launch.restype = ci
        lib.psm_error_string.argtypes = [ci]
        lib.psm_error_string.restype = ctypes.c_char_p
        _lib = lib
        return time.perf_counter() - t0


def _check(fn: str, name: str, t: torch.Tensor, dtype, shape, dev) -> None:
    if (t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous()
            or t.device != dev):
        raise ValueError(
            f"{fn}: {name} must be a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _on_device(fn: str, name: str, scan: Scan, dev) -> None:
    if any(x.device != dev for x in scan):
        raise ValueError(f"{fn}: {name} is not on {dev}")


def _model_args(model: LaserModel) -> tuple:
    return (
        model.n_beams, model.window, model.dfi, model.min_range, model.max_range,
        psm.WEIGHTING_FACTOR, model.min_valid_points, psm.MAX_ITER // 2,
        psm.CHANGE_WEIGHT_ITER // 2,
    )


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: {_lib.psm_error_string(rc).decode()}")


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def match_psm_fused(
    model: LaserModel,
    ref: Scan,
    cur: Scan,
    init_pose: torch.Tensor | None = None,
    error_ref: Scan | None = None,
    banded: bool = False,
):
    """Batched PSM match of ``cur`` against ``ref`` (``[B, N]`` scans),
    ``init_pose [B, 3]``; the function of :func:`..psm.match_psm`.

    With ``error_ref`` (``[B, N]`` scans) it returns ``(result, (err_x,
    err_y, n))``, the second being :func:`..psm.error_index` of ``cur`` at
    the matched pose against ``error_ref``, computed in the same launch.

    CPU inputs run the plain versions; CUDA inputs launch the kernel
    (counted in ``match_psm_fused.launches``; the pairs' iteration counts
    of the last launch stay on the card in ``match_psm_fused.last_iters``)
    or raise.

    The kernel projects densely: ``banded=True`` raises (call
    ``psm.match_psm(..., banded=True)``, the plain banded matcher).
    """
    if banded:
        raise ValueError("match_psm_fused: the kernel projects densely; use "
                         "psm.match_psm(..., banded=True) for the banded projection")
    dev = cur.ranges.device
    if dev.type == "cpu":
        res = psm.match_psm(model, ref, cur, init_pose)
        if error_ref is None:
            return res
        return res, psm.error_index(model, error_ref, cur, res.pose)
    if dev.type != "cuda":
        raise ValueError(f"match_psm_fused: unsupported device {dev}")
    if cur.ranges.dim() != 2:
        raise ValueError("match_psm_fused: scans must be [B, N]")
    b, n = cur.ranges.shape
    if n != model.n_beams or n > MAX_BEAMS:
        raise ValueError(f"match_psm_fused: {n} beams (model {model.n_beams}, max {MAX_BEAMS})")
    if init_pose is None:
        init_pose = torch.zeros(b, 3, dtype=torch.float32, device=dev)
    fn = "match_psm_fused"
    _check(fn, "ref.ranges", ref.ranges, torch.float32, (b, n), dev)
    _check(fn, "ref.bad", ref.bad, torch.bool, (b, n), dev)
    _check(fn, "cur.ranges", cur.ranges, torch.float32, (b, n), dev)
    _on_device(fn, "cur", cur, dev)
    _check(fn, "init_pose", init_pose, torch.float32, (b, 3), dev)
    if error_ref is not None:
        _check(fn, "error_ref.ranges", error_ref.ranges, torch.float32, (b, n), dev)
        _check(fn, "error_ref.bad", error_ref.bad, torch.bool, (b, n), dev)

    build()
    pair_ok = _pair_valid_from_seg(cur).contiguous()
    fi = model.bearings(torch.float32, dev)
    pose = torch.empty(b, 3, dtype=torch.float32, device=dev)
    err = torch.empty(b, dtype=torch.float32, device=dev)
    fail = torch.empty(b, dtype=torch.bool, device=dev)
    iters = torch.empty(b, dtype=torch.int32, device=dev)
    ex = ey = en = None
    if error_ref is not None:
        ex = torch.empty(b, dtype=torch.float32, device=dev)
        ey = torch.empty(b, dtype=torch.float32, device=dev)
        en = torch.empty(b, dtype=torch.int32, device=dev)
    rc = _lib.psm_match_launch(
        ref.ranges.data_ptr(), ref.bad.data_ptr(), cur.ranges.data_ptr(),
        pair_ok.data_ptr(),
        _ptr(error_ref and error_ref.ranges), _ptr(error_ref and error_ref.bad),
        fi.data_ptr(), init_pose.data_ptr(),
        pose.data_ptr(), err.data_ptr(), fail.data_ptr(), iters.data_ptr(),
        _ptr(ex), _ptr(ey), _ptr(en),
        b, *_model_args(model), _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "PSM kernel")
    match_psm_fused.launches += 1
    match_psm_fused.last_iters = iters
    res = psm.MatchResult(
        pose=pose, err=err, fail=fail,
        n_valid=torch.zeros(b, dtype=torch.int32, device=dev),
    )
    return res if error_ref is None else (res, (ex, ey, en))


match_psm_fused.launches = 0
match_psm_fused.last_iters = None


def odometry_chain_fused(
    model: LaserModel, scans: Scan, switch_thresh: float, weak_thresh: float
):
    """Pass 1 of the keyframe odometry over a preprocessed ``[T, N]`` log
    on a CUDA device, in one kernel launch: for every scan after the
    first, the match against the keyframe and against the previous scan,
    both error indices, the keyframe switch (error above
    ``switch_thresh`` m), the weak flag (``weak_thresh``) and the pose
    composition, exactly as ``odometry._step`` chains them.

    Returns ``(poses [T-1, 3], switched, discarded, deep_flag)`` (bool
    ``[T-1]``). The launch is counted in ``odometry_chain_fused.launches``
    and the steps' two iteration counts stay on the card in
    ``odometry_chain_fused.last_iters`` (``[T-1, 2]``). Raises on tensors
    that are not on a CUDA device: the plain version is the step loop of
    ``odometry.odometry_keyframe``.
    """
    dev = scans.ranges.device
    if dev.type != "cuda":
        raise ValueError(f"odometry_chain_fused: needs CUDA tensors, got {dev}")
    if scans.ranges.dim() != 2:
        raise ValueError("odometry_chain_fused: scans must be [T, N]")
    t, n = scans.ranges.shape
    if n != model.n_beams or n > MAX_BEAMS or t < 1:
        raise ValueError(
            f"odometry_chain_fused: {t} scans of {n} beams (model {model.n_beams}, "
            f"max {MAX_BEAMS})")
    fn = "odometry_chain_fused"
    _check(fn, "scans.ranges", scans.ranges, torch.float32, (t, n), dev)
    _check(fn, "scans.bad", scans.bad, torch.bool, (t, n), dev)
    _on_device(fn, "scans", scans, dev)

    poses = torch.empty(t - 1, 3, dtype=torch.float32, device=dev)
    switched, discarded, deep = (
        torch.empty(t - 1, dtype=torch.bool, device=dev) for _ in range(3))
    iters = torch.empty(t - 1, 2, dtype=torch.int32, device=dev)
    if t == 1:
        return poses, switched, discarded, deep
    build()
    pair_ok = _pair_valid_from_seg(scans).contiguous()
    fi = model.bearings(torch.float32, dev)
    rc = _lib.psm_chain_launch(
        scans.ranges.data_ptr(), scans.bad.data_ptr(), pair_ok.data_ptr(),
        fi.data_ptr(), poses.data_ptr(), switched.data_ptr(), discarded.data_ptr(),
        deep.data_ptr(), iters.data_ptr(),
        t, *_model_args(model), switch_thresh, weak_thresh, _device_index(dev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(rc, "PSM chain kernel")
    odometry_chain_fused.launches += 1
    odometry_chain_fused.last_iters = iters
    return poses, switched, discarded, deep


odometry_chain_fused.launches = 0
odometry_chain_fused.last_iters = None
