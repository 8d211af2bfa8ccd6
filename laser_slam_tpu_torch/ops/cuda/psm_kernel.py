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

The source is built by :mod:`.nvcc` at first use, and each entry
launches as an operator of PyTorch's dispatcher
(``laser_slam_tpu_torch::psm_match``, ``::psm_chain``). CPU tensors take
the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_void_p

import torch

from ...core.scan import LaserModel, Scan
from .. import psm
from ..project import _pair_valid_from_seg
from . import nvcc

MAX_BEAMS = 544

_MODEL = [c_int, c_int, c_float, c_float, c_float, c_float, c_int, c_int, c_int]
KERNEL = nvcc.Kernel(nvcc.PKG / "csrc" / "psm_kernel.cu", {
    # tensors, batch, model, device, stream
    "psm_match_launch": [*[c_void_p] * 15, c_int, *_MODEL, c_int, c_void_p],
    # tensors, n_scans, model, the two thresholds, device, stream
    "psm_chain_launch": [*[c_void_p] * 9, c_int, *_MODEL, c_float, c_float, c_int, c_void_p],
}, "psm_error_string")


def build() -> float:
    """Compile (if needed) and load the kernel library; returns the
    seconds spent, 0 when it was already loaded."""
    return KERNEL.build()


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

    pair_ok = _pair_valid_from_seg(cur).contiguous()
    fi = model.bearings(torch.float32, dev)
    pose, err, fail, iters, ex, ey, en = torch.ops.laser_slam_tpu_torch.psm_match.default(
        ref.ranges, ref.bad, cur.ranges, pair_ok, error_ref and error_ref.ranges,
        error_ref and error_ref.bad, fi, init_pose, *_model_args(model))
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

    if t == 1:
        return (torch.empty(0, 3, dtype=torch.float32, device=dev),
                *(torch.empty(0, dtype=torch.bool, device=dev) for _ in range(3)))
    pair_ok = _pair_valid_from_seg(scans).contiguous()
    fi = model.bearings(torch.float32, dev)
    poses, switched, discarded, deep, iters = torch.ops.laser_slam_tpu_torch.psm_chain.default(
        scans.ranges, scans.bad, pair_ok, fi, *_model_args(model), switch_thresh, weak_thresh)
    odometry_chain_fused.launches += 1
    odometry_chain_fused.last_iters = iters
    return poses, switched, discarded, deep


odometry_chain_fused.launches = 0
odometry_chain_fused.last_iters = None


def _match(ref_r, ref_bad, cur_r, pair_ok, eref_r, eref_bad, fi, init, *model):
    b = cur_r.shape[0]
    dev = cur_r.device
    pose = torch.empty(b, 3, dtype=torch.float32, device=dev)
    err = torch.empty(b, dtype=torch.float32, device=dev)
    fail = torch.empty(b, dtype=torch.bool, device=dev)
    iters = torch.empty(b, dtype=torch.int32, device=dev)
    ex = ey = en = None
    if eref_r is not None:
        ex = torch.empty(b, dtype=torch.float32, device=dev)
        ey = torch.empty(b, dtype=torch.float32, device=dev)
        en = torch.empty(b, dtype=torch.int32, device=dev)
    KERNEL.launch(
        "psm_match_launch", ref_r.data_ptr(), ref_bad.data_ptr(), cur_r.data_ptr(),
        pair_ok.data_ptr(), _ptr(eref_r), _ptr(eref_bad), fi.data_ptr(), init.data_ptr(),
        pose.data_ptr(), err.data_ptr(), fail.data_ptr(), iters.data_ptr(),
        _ptr(ex), _ptr(ey), _ptr(en), b, *model, device=dev,
    )
    return pose, err, fail, iters, ex, ey, en


def _chain(ranges, bad, pair_ok, fi, *args):
    t = ranges.shape[0]
    dev = ranges.device
    poses = torch.empty(t - 1, 3, dtype=torch.float32, device=dev)
    switched, discarded, deep = (
        torch.empty(t - 1, dtype=torch.bool, device=dev) for _ in range(3))
    iters = torch.empty(t - 1, 2, dtype=torch.int32, device=dev)
    KERNEL.launch(
        "psm_chain_launch", ranges.data_ptr(), bad.data_ptr(), pair_ok.data_ptr(),
        fi.data_ptr(), poses.data_ptr(), switched.data_ptr(), discarded.data_ptr(),
        deep.data_ptr(), iters.data_ptr(), t, *args, device=dev,
    )
    return poses, switched, discarded, deep, iters


_MODEL_ARGS = ("int n, int window, float dfi, float min_range, float max_range, float weighting, "
               "int min_valid_points, int max_iters, int change_weight_it")
nvcc.register(f"psm_match(Tensor ref_r, Tensor ref_bad, Tensor cur_r, Tensor pair_ok, "
              f"Tensor? eref_r, Tensor? eref_bad, Tensor fi, Tensor init, {_MODEL_ARGS}) -> "
              f"(Tensor, Tensor, Tensor, Tensor, Tensor?, Tensor?, Tensor?)", _match)
nvcc.register(f"psm_chain(Tensor ranges, Tensor bad, Tensor pair_ok, Tensor fi, {_MODEL_ARGS}, "
              f"float switch_thresh, float weak_thresh) -> (Tensor, Tensor, Tensor, Tensor, Tensor)",
              _chain)
