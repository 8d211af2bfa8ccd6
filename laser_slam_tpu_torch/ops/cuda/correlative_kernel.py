"""Host wrapper of the sparse correlative score-volume CUDA kernel
(``csrc/correlative_kernel.cu``).

:func:`score_volume_sparse` sums, for every rotation and shift of the
correlative search, the grid under the rotated cloud's occupied cells:
the volume that ``ops/correlative.correlative_score_volume`` divides by
its point counts. Its plain version is ``correlative._score_volume_conv``
(a count raster of the cloud cross-correlated with the zero-padded grid,
one grouped ``conv2d``), which the kernel follows bit for bit where that
convolution runs PyTorch's depthwise kernel (more than one row). CPU
tensors take the plain version in ``correlative_score_volume``; this
wrapper launches the kernel on CUDA tensors or raises.

The source is built by :mod:`.nvcc` at first use.
"""

from __future__ import annotations

from ctypes import c_int, c_void_p

import torch

from . import nvcc

MAX_POINTS = 4096   # points a (row, rotation): the kernel sorts them in shared memory

KERNEL = nvcc.Kernel(nvcc.PKG / "csrc" / "correlative_kernel.cu", {
    # planes, cells, out, n_planes, batch, k_rot, n, g, n_steps, device, stream
    "corr_volume_launch": [*[c_void_p] * 3, *[c_int] * 7, c_void_p],
}, "corr_error_string")


def score_volume_sparse(planes: torch.Tensor, cells: torch.Tensor, n_steps: int) -> torch.Tensor:
    """Score sums ``[C, B, K, T, T]`` (plane, row, rotation, y-shift,
    x-shift; ``T = 2·n_steps + 1``) of grids ``planes [C, B, G, G]``
    (float32, ``C`` 1 or 2) under the rotated clouds' cells ``cells
    [B, K, N]`` (int32 ``iy·G + ix``, negative for a point dropped at
    every shift, at most :data:`MAX_POINTS` points): at shift ``(a, c)``
    each point adds ``plane[iy + a - n_steps][ix + c - n_steps]``, 0 off
    the plane.

    Both tensors contiguous and on one CUDA device; anything else raises.
    Launches are counted in ``score_volume_sparse.launches`` (none for an
    empty ``B · K``)."""
    fn = "score_volume_sparse"
    if planes.dim() != 4 or cells.dim() != 3:
        raise ValueError(f"{fn}: planes must be [C, B, G, G] and cells [B, K, N], got "
                         f"{tuple(planes.shape)} and {tuple(cells.shape)}")
    c, b, g, g2 = planes.shape
    _, k, n = cells.shape
    if c not in (1, 2) or g != g2 or cells.shape[0] != b:
        raise ValueError(f"{fn}: planes {tuple(planes.shape)} do not fit cells "
                         f"{tuple(cells.shape)} (1 or 2 square planes a row)")
    if n > MAX_POINTS:
        raise ValueError(f"{fn}: {n} points a row, the kernel takes at most {MAX_POINTS}")
    if planes.dtype != torch.float32 or cells.dtype != torch.int32:
        raise ValueError(f"{fn}: planes must be float32 and cells int32, got "
                         f"{planes.dtype} and {cells.dtype}")
    if not (planes.is_contiguous() and cells.is_contiguous()):
        raise ValueError(f"{fn}: planes and cells must be contiguous")
    dev = planes.device
    if dev.type != "cuda" or cells.device != dev:
        raise ValueError(f"{fn}: needs both tensors on one CUDA device, got {dev} and "
                         f"{cells.device} (the plain version is correlative._score_volume_conv)")
    if n_steps < 0 or g * g >= 2 ** 31:
        raise ValueError(f"{fn}: n_steps {n_steps} and a {g} x {g} grid are out of range")
    return torch.ops.laser_slam_tpu_torch.corr_volume.default(planes, cells, n_steps)


def _launch(planes: torch.Tensor, cells: torch.Tensor, n_steps: int) -> torch.Tensor:
    c, b, g, _ = planes.shape
    _, k, n = cells.shape
    t = 2 * n_steps + 1
    dev = planes.device
    out = torch.empty(c, b, k, t, t, dtype=torch.float32, device=dev)
    if b * k == 0:
        return out
    KERNEL.launch("corr_volume_launch", planes.data_ptr(), cells.data_ptr(), out.data_ptr(),
                  c, b, k, n, g, n_steps, device=dev)
    score_volume_sparse.launches += 1
    return out


score_volume_sparse.launches = 0
nvcc.register("corr_volume(Tensor planes, Tensor cells, int n_steps) -> Tensor", _launch)
