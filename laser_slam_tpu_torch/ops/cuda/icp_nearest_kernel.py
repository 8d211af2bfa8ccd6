"""Host wrapper of the point-ICP nearest-two search's CUDA kernel
(``csrc/icp_nearest_kernel.cu``).

:func:`nearest_two` finds, for each observed point, the nearest and the
second-nearest valid reference point: the correspondence search of
``ops/icp_points.match_icp_points``, equal bit for bit to its plain version
``icp_points._nearest_two_plain`` (the ``[B, N, M]`` distance matrix and
two argmins) on the same card. CPU tensors and other dtypes take the plain
version in ``match_icp_points``; this wrapper launches the kernel on CUDA
float32 tensors or raises.

The source is built by :mod:`.nvcc` at first use.
"""

from __future__ import annotations

from ctypes import c_int, c_int64, c_void_p

import torch

from . import nvcc

MAX_POINTS = 2 ** 31 - 2     # points and batches: the kernel counts them in int

KERNEL = nvcc.Kernel(nvcc.PKG / "csrc" / "icp_nearest_kernel.cu", {
    # q, ref, valid, j, j2, nn_ok, batch, n, m, ref strides (batch, point, coordinate),
    # valid strides (batch, point), device, stream
    "nearest_two_launch": [*[c_void_p] * 6, *[c_int] * 3, *[c_int64] * 5, c_int, c_void_p],
}, "nearest_two_error_string")


def nearest_two(q: torch.Tensor, ref_pts: torch.Tensor,
                ref_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """For each point of ``q [B, N, 2]``, the index ``j [B, N]`` (int64)
    of its nearest point of ``ref_pts [B, M, 2]`` among those that
    ``ref_valid [B, M]`` keeps, the index ``j2`` of the second nearest and
    ``nn_ok [B, N]``, whether the nearest lies at a finite distance; the
    first index among equal distances, ``0`` where no candidate is left,
    as ``torch.argmin`` gives them.

    ``q`` contiguous float32, ``ref_pts`` float32 and ``ref_valid`` bool
    at any strides (0 for a cloud expanded over the batch: it is read, not
    copied), all on one CUDA device, at least one reference point.
    Anything else raises. Launches are counted in
    ``nearest_two.launches`` (none for no points)."""
    fn = "nearest_two"
    if q.dim() != 3 or q.shape[2] != 2 or ref_pts.dim() != 3 or ref_pts.shape[2] != 2:
        raise ValueError(f"{fn}: q must be [B, N, 2] and ref_pts [B, M, 2], got "
                         f"{tuple(q.shape)} and {tuple(ref_pts.shape)}")
    if ref_valid.shape != ref_pts.shape[:2] or ref_pts.shape[0] != q.shape[0]:
        raise ValueError(f"{fn}: ref_valid must be [B, M] for ref_pts [B, M, 2] and q [B, N, 2], "
                         f"got {tuple(ref_valid.shape)}, {tuple(ref_pts.shape)} and "
                         f"{tuple(q.shape)}")
    if q.dtype != torch.float32 or ref_pts.dtype != torch.float32 or ref_valid.dtype != torch.bool:
        raise ValueError(f"{fn}: q and ref_pts must be float32 and ref_valid bool, got "
                         f"{q.dtype}, {ref_pts.dtype} and {ref_valid.dtype} (the plain version is "
                         f"icp_points._nearest_two_plain)")
    if not 1 <= ref_pts.shape[1] <= MAX_POINTS or max(q.shape[:2]) > MAX_POINTS:
        raise ValueError(f"{fn}: {ref_pts.shape[1]} reference points or {q.shape[0]} x "
                         f"{q.shape[1]} observed points out of range")
    if not q.is_contiguous():
        raise ValueError(f"{fn}: q must be contiguous")
    tensors = (q, ref_pts, ref_valid)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{fn}: needs all three tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]} (the plain version is "
                         f"icp_points._nearest_two_plain)")
    return torch.ops.laser_slam_tpu_torch.nearest_two.default(q, ref_pts, ref_valid)


def _launch(q: torch.Tensor, ref_pts: torch.Tensor,
            ref_valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, n, _ = q.shape
    m = ref_pts.shape[1]
    dev = q.device
    j = torch.empty(b, n, dtype=torch.int64, device=dev)
    j2 = torch.empty(b, n, dtype=torch.int64, device=dev)
    nn_ok = torch.empty(b, n, dtype=torch.bool, device=dev)
    if b * n == 0:
        return j, j2, nn_ok
    KERNEL.launch(
        "nearest_two_launch", q.data_ptr(), ref_pts.data_ptr(), ref_valid.data_ptr(),
        j.data_ptr(), j2.data_ptr(), nn_ok.data_ptr(), b, n, m, *ref_pts.stride(),
        *ref_valid.stride(), device=dev,
    )
    nearest_two.launches += 1
    return j, j2, nn_ok


nearest_two.launches = 0
nvcc.register("nearest_two(Tensor q, Tensor ref_pts, Tensor ref_valid) -> (Tensor, Tensor, Tensor)",
              _launch)
