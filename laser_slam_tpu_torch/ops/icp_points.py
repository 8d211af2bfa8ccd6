"""Free-form point-cloud ICP, batched over pairs (port of
``ops/icp_points.py``).

Correspondences come from the nearest and second-nearest reference point
of each point (point-to-segment target): on CUDA float32 tensors one
launch of ``csrc/icp_nearest_kernel.cu`` a search, elsewhere a masked
``[B, N, M]`` distance matrix; the gate anneals from ``max_corr`` to
``min_corr``; the worst 10 % of matches are trimmed; the update is the
closed-form rigid alignment.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import se2
from ..utils.profiling import profiler, trace
from .cuda.icp_nearest_kernel import nearest_two

Tensor = torch.Tensor

DEFAULT_ITERS = 40
MAX_CORR = 1.0       # [m] starting correspondence gate
MIN_CORR = 0.10      # [m] final correspondence gate
CORR_DECAY = 0.85    # per-iteration threshold decay
TRIM_FRACTION = 0.1  # drop the worst matches each iteration
MIN_POINTS = 20


class PointIcpResult(NamedTuple):
    pose: Tensor      # [B, 3] relative pose: cur → ref frame
    err: Tensor       # [B] mean matched distance [m]
    goodness: Tensor  # [B] fraction of cur points matched at the final gate
    fail: Tensor      # [B] bool
    n_matched: Tensor # [B] int32
    cov: Tensor | None = None  # [B, 3, 3] Censi-style pose covariance


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _gather_pts(pts: Tensor, idx: Tensor) -> Tensor:
    """``pts [B, M, 2]`` at ``idx [B, N]`` → ``[B, N, 2]``."""
    return torch.gather(pts, 1, idx[..., None].expand(-1, -1, 2))


# Bytes per (row, point, reference point) that an iteration's plain search
# holds: the squared-distance matrix, its masked copy for the
# second-nearest search and the comparison masks, float32 and bool.
BYTES_PER_PAIR = 4 + 4 + 4 + 2
# Bytes per (row, point) of an iteration where the kernel searches and no
# ``[B, N, M]`` tensor is held: every ``[B, N]`` and ``[B, N, 2]``
# intermediate of the search and the update (about 290 bytes) counted as
# if all were live at once, rounded up.
BYTES_PER_POINT = 320


def searches_on_kernel(cur_pts: Tensor, ref_pts: Tensor) -> bool:
    """Whether :func:`match_icp_points` of these clouds searches with the
    kernel (CUDA float32: no ``[B, N, M]`` tensor held) or the plain
    block (:func:`_nearest_two_plain`)."""
    return cur_pts.is_cuda and cur_pts.dtype == ref_pts.dtype == torch.float32


def bytes_per_row(cur_pts: Tensor, ref_pts: Tensor) -> int:
    """The bytes that one row of the batch holds at once in an iteration
    of :func:`match_icp_points` of ``cur_pts [B, N, 2]`` onto ``ref_pts
    [B, M, 2]``, on the search their device and dtype pick: ``N ·
    BYTES_PER_POINT`` on the kernel, ``N · M · BYTES_PER_PAIR`` on the
    plain block. Callers size their chunks of rows by it."""
    n, m = cur_pts.shape[-2], ref_pts.shape[-2]
    return n * BYTES_PER_POINT if searches_on_kernel(cur_pts, ref_pts) else n * m * BYTES_PER_PAIR


def _nearest_two(q: Tensor, ref_pts: Tensor, ref_valid: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The nearest and second-nearest valid reference point of each point
    of ``q [B, N, 2]`` and whether the nearest is at a finite distance:
    ``(j, j2, nn_ok)``, each ``[B, N]``. On CUDA float32 tensors one
    launch of the kernel (``nearest_two``, counted in the profiler's
    ``icp.nearest_two_launches``), equal bit for bit to the plain block;
    on anything else the plain block."""
    if not searches_on_kernel(q, ref_pts):
        return _nearest_two_plain(q, ref_pts, ref_valid)
    b, m = q.shape[0], ref_pts.shape[1]
    out = nearest_two(q.contiguous(), ref_pts.expand(b, m, 2), ref_valid.expand(b, m))
    profiler.count("icp.nearest_two_launches", 1)
    return out


def _nearest_two_plain(q: Tensor, ref_pts: Tensor,
                       ref_valid: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The plain version of :func:`_nearest_two`, on any device: the
    masked ``[B, N, M]`` squared distances and two argmins."""
    rx, ry = ref_pts[:, None, :, 0], ref_pts[:, None, :, 1]           # [B, 1, M]
    dx = q[:, :, 0, None] - rx
    dy = q[:, :, 1, None] - ry
    d2 = torch.where(ref_valid[:, None, :], dx * dx + dy * dy, torch.inf)   # [B, N, M]
    del dx, dy
    j = torch.argmin(d2, dim=-1)
    nn_ok = torch.isfinite(torch.gather(d2, -1, j[..., None])[..., 0])
    d2.scatter_(-1, j[..., None], torch.inf)   # d2 is not read again
    j2 = torch.argmin(d2, dim=-1)
    return j, j2, nn_ok


def match_icp_points(
    ref_pts: Tensor,
    ref_valid: Tensor,
    cur_pts: Tensor,
    cur_valid: Tensor,
    init_pose: Tensor | None = None,
    iters: int = DEFAULT_ITERS,
    max_corr: float = MAX_CORR,
    min_corr: float = MIN_CORR,
    steps_per_nn: int = 1,
) -> PointIcpResult:
    """Align ``cur_pts [B, N, 2]`` onto ``ref_pts [B, M, 2]`` (masked
    points excluded). The clouds may be strided views.

    ``steps_per_nn > 1`` reuses each correspondence search (the
    nearest-two search) for that many pose updates: the
    nearest-segment endpoints stay fixed while the projection target,
    gate, trim and closed-form update are recomputed per step. ``iters``
    still counts pose updates and the gate-decay schedule is unchanged
    (when ``steps_per_nn`` does not divide ``iters``, the last search
    runs its full count of updates)."""
    dtype, dev = cur_pts.dtype, cur_pts.device
    b, n = cur_pts.shape[:2]
    pose = (
        torch.zeros(b, 3, dtype=dtype, device=dev)
        if init_pose is None else init_pose.to(dtype)
    )
    err = torch.full((b,), 1e6, dtype=dtype, device=dev)
    nm = torch.zeros(b, dtype=torch.int32, device=dev)
    match = torch.zeros(b, n, dtype=torch.bool, device=dev)
    seg_max2 = (4.0 * min_corr) ** 2

    n_outer = max((iters + steps_per_nn - 1) // steps_per_nn, 1)
    for it in range(n_outer):
        q = se2.transform_points(pose, cur_pts)                       # [B, N, 2]
        with trace("h1_nearest_two"):
            # Second nearest: the point-to-segment target lies between the
            # two nearest reference points.
            j, j2, nn_ok = _nearest_two(q, ref_pts, ref_valid)
        p1 = _gather_pts(ref_pts, j)
        seg = _gather_pts(ref_pts, j2) - p1
        len2 = torch.sum(seg * seg, dim=-1)
        len2_safe = torch.where(len2 < 1e-12, 1.0, len2)
        seg_ok = len2 < seg_max2

        for sub in range(steps_per_nn):
            if sub:
                q = se2.transform_points(pose, cur_pts)
            tproj = torch.clamp(torch.sum((q - p1) * seg, dim=-1) / len2_safe, 0.0, 1.0)
            proj = p1 + tproj[..., None] * seg
            target = torch.where(seg_ok[..., None], proj, p1)
            dist = torch.where(seg_ok, _norm(q - proj), _norm(q - p1))

            # float32 gate schedule, max(max_corr·decay^step, min_corr).
            step = np.float32(it * steps_per_nn + sub)
            gate = float(max(np.float32(max_corr) * np.float32(CORR_DECAY) ** step,
                             np.float32(min_corr)))
            match = cur_valid & nn_ok & (dist < gate)

            # Trim the worst TRIM_FRACTION of matches (quantile cut).
            srt = torch.sort(torch.where(match, dist, torch.inf), dim=-1).values
            nm = torch.sum(match, dim=-1, dtype=torch.int32)
            k = torch.clamp((nm.to(dtype) * (1.0 - TRIM_FRACTION)).to(torch.int32) - 1, 0, n - 1)
            keep = match & (dist <= torch.gather(srt, -1, k[:, None].long()))

            wk = keep.to(dtype)
            m = torch.clamp(torch.sum(wk, dim=-1), min=1.0)
            mean_q = torch.sum(q * wk[..., None], dim=1) / m[:, None]
            mean_t = torch.sum(target * wk[..., None], dim=1) / m[:, None]
            dq = (q - mean_q[:, None]) * wk[..., None]
            dt = target - mean_t[:, None]
            sxx = torch.sum(dq[..., 0] * dt[..., 0], dim=-1)
            sxy = torch.sum(dq[..., 0] * dt[..., 1], dim=-1)
            syx = torch.sum(dq[..., 1] * dt[..., 0], dim=-1)
            syy = torch.sum(dq[..., 1] * dt[..., 1], dim=-1)
            dth = torch.atan2(sxy - syx, sxx + syy)
            cd, sd = torch.cos(dth), torch.sin(dth)
            # Rotate the moved cloud about its matched centroid, then translate.
            dx_ = mean_t[:, 0] - (cd * mean_q[:, 0] - sd * mean_q[:, 1])
            dy_ = mean_t[:, 1] - (sd * mean_q[:, 0] + cd * mean_q[:, 1])
            pose = se2.compose(torch.stack([dx_, dy_, dth], dim=-1), pose)
            err = torch.sum(torch.where(keep, dist, 0.0), dim=-1) / m

    n_cur = torch.clamp(torch.sum(cur_valid, dim=-1, dtype=torch.int32), min=1)
    goodness = nm.to(dtype) / n_cur.to(dtype)
    fail = nm < MIN_POINTS

    # Censi-style covariance from the final correspondence set:
    # J_k = [I₂ | R'(θ)p_k], H = Σ J_kᵀJ_k, cov = σ²·H⁻¹ with a floored σ.
    c, s = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
    dpx = -s * cur_pts[..., 0] - c * cur_pts[..., 1]
    dpy = c * cur_pts[..., 0] - s * cur_pts[..., 1]
    w = match.to(dtype)
    m = torch.clamp(torch.sum(w, dim=-1), min=1.0)
    h02 = torch.sum(w * dpx, dim=-1)
    h12 = torch.sum(w * dpy, dim=-1)
    h22 = torch.sum(w * (dpx * dpx + dpy * dpy), dim=-1)
    zero = torch.zeros_like(m)
    H = torch.stack(
        [
            torch.stack([m, zero, h02], dim=-1),
            torch.stack([zero, m, h12], dim=-1),
            torch.stack([h02, h12, h22], dim=-1),
        ],
        dim=-2,
    )
    sigma2 = torch.clamp(err * err, min=(0.5 * min_corr) ** 2)
    eye = torch.eye(3, dtype=dtype, device=dev)
    cov = sigma2[:, None, None] * torch.linalg.inv_ex(H + 1e-3 * eye)[0]
    return PointIcpResult(
        pose=pose, err=err, goodness=goodness, fail=fail, n_matched=nm, cov=cov
    )


def scan_to_points(model, scan) -> tuple[Tensor, Tensor]:
    """Valid beam endpoints of a scan as a masked point cloud
    ``([..., N, 2], [..., N] bool)`` in the sensor frame."""
    fi = model.bearings(scan.ranges.dtype, scan.ranges.device)
    pts = torch.stack(
        [scan.ranges * torch.cos(fi), scan.ranges * torch.sin(fi)], dim=-1
    )
    valid = ~scan.bad & (scan.ranges < model.max_range) & (
        scan.ranges > model.min_range
    )
    return pts, valid
