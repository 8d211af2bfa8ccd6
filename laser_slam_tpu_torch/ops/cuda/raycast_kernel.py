"""Host wrapper of the beam model's ray-march CUDA kernel
(``csrc/raycast_kernel.cu``).

:func:`ray_march` walks each (pose, beam) ray from its first range
sample and stops at the first occupied cell: the simulated ranges of
``localization/raycast.simulate_scan``, equal bit for bit to its plain
version ``raycast._simulate_scan_ladder`` (the dense ``[..., N, S]``
ladder) on the same card. CPU tensors take the plain version in
``simulate_scan``; this wrapper launches the kernel on CUDA tensors or
raises.

The source is built by :mod:`.nvcc` at first use.
"""

from __future__ import annotations

from ctypes import c_float, c_int, c_void_p

import numpy as np
import torch

from . import nvcc

MAX_SAMPLES = 1 << 24     # samples a ray: the kernel counts them in exact float32
MAX_BEAMS = 65535         # beams: the launch's second grid dimension

KERNEL = nvcc.Kernel(nvcc.PKG / "csrc" / "raycast_kernel.cu", {
    # occupied, height, width, pose, cos_a, sin_a, out, n_poses, n_beams, origin_x, origin_y,
    # inv_res, res, n_samples, max_range, device, stream
    "ray_march_launch": [c_void_p, c_int, c_int, *[c_void_p] * 4, c_int, c_int,
                         *[c_float] * 4, c_int, c_float, c_int, c_void_p],
}, "ray_march_error_string")


def ray_march(occupied: torch.Tensor, pose: torch.Tensor, cos_a: torch.Tensor,
              sin_a: torch.Tensor, origin_x: float, origin_y: float, resolution: float,
              n_samples: int, max_range: float) -> torch.Tensor:
    """Simulated ranges ``[R, N]`` of poses ``pose [R, 3]`` along beams
    whose angles have cosines ``cos_a [R, N]`` and sines ``sin_a [R, N]``,
    on the map ``occupied [H, W]`` (bool, row = y) whose cell ``(0, 0)``
    has its corner at ``(origin_x, origin_y)``: for each ray, ``(k + 1) ·
    resolution`` of its first sample ``k < n_samples`` on an occupied
    cell, ``max_range`` where there is none.

    All four tensors contiguous and on one CUDA device, the three of the
    rays float32, the map under 2**31 cells; anything else raises.
    Launches are counted in ``ray_march.launches`` (none for no rays)."""
    fn = "ray_march"
    if occupied.dim() != 2 or pose.dim() != 2 or pose.shape[1] != 3:
        raise ValueError(f"{fn}: occupied must be [H, W] and pose [R, 3], got "
                         f"{tuple(occupied.shape)} and {tuple(pose.shape)}")
    if cos_a.dim() != 2 or cos_a.shape != sin_a.shape or cos_a.shape[0] != pose.shape[0]:
        raise ValueError(f"{fn}: cos_a and sin_a must both be [R, N] for pose [R, 3], got "
                         f"{tuple(cos_a.shape)}, {tuple(sin_a.shape)} and {tuple(pose.shape)}")
    if occupied.dtype != torch.bool or any(t.dtype != torch.float32 for t in (pose, cos_a, sin_a)):
        raise ValueError(f"{fn}: occupied must be bool and pose, cos_a, sin_a float32, got "
                         f"{occupied.dtype}, {pose.dtype}, {cos_a.dtype}, {sin_a.dtype}")
    tensors = (occupied, pose, cos_a, sin_a)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{fn}: occupied, pose, cos_a and sin_a must be contiguous")
    dev = pose.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{fn}: needs all four tensors on one CUDA device, got "
                         f"{[str(t.device) for t in tensors]} (the plain version is "
                         f"raycast._simulate_scan_ladder)")
    if occupied.numel() == 0 or occupied.numel() >= 2 ** 31:
        raise ValueError(f"{fn}: a map of {tuple(occupied.shape)} cells is out of range "
                         f"(1 to 2**31 - 1)")
    if not (0 <= n_samples < MAX_SAMPLES and cos_a.shape[1] <= MAX_BEAMS and resolution > 0):
        raise ValueError(f"{fn}: {n_samples} samples, {cos_a.shape[1]} beams or resolution "
                         f"{resolution} out of range")
    return torch.ops.laser_slam_tpu_torch.ray_march.default(
        occupied, pose, cos_a, sin_a, origin_x, origin_y, resolution, n_samples, max_range)


def _launch(occupied: torch.Tensor, pose: torch.Tensor, cos_a: torch.Tensor,
            sin_a: torch.Tensor, origin_x: float, origin_y: float, resolution: float,
            n_samples: int, max_range: float) -> torch.Tensor:
    r, n = cos_a.shape
    h, w = occupied.shape
    dev = pose.device
    out = torch.empty(r, n, dtype=torch.float32, device=dev)
    if r * n == 0:
        return out
    # ATen divides a CUDA tensor by a Python scalar as a multiplication by
    # the scalar's float32 reciprocal, computed in float32.
    inv_res = float(np.float32(1.0) / np.float32(resolution))
    KERNEL.launch(
        "ray_march_launch", occupied.data_ptr(), h, w, pose.data_ptr(), cos_a.data_ptr(),
        sin_a.data_ptr(), out.data_ptr(), r, n, origin_x, origin_y, inv_res, resolution,
        n_samples, max_range, device=dev,
    )
    ray_march.launches += 1
    return out


ray_march.launches = 0
nvcc.register("ray_march(Tensor occupied, Tensor pose, Tensor cos_a, Tensor sin_a, float origin_x, "
              "float origin_y, float resolution, int n_samples, float max_range) -> Tensor", _launch)
