"""Point-to-line ICP (PL-ICP) with Gauss-Newton and a covariance, batched
over pairs (port of ``ops/plicp.py``).

Per iteration the banded correspondence search is a gathered
``[B, N, 2W+1]`` distance matrix; the two nearest reference points form a
line; the linearized point-to-line least squares is solved in closed form
(a 3×3 system per pair), after an adaptive outlier trim (the 70th
percentile × 2, capped at the 95th). The covariance is the Gauss-Newton
normal matrix's inverse scaled by the residual variance. Pairs that
converged (ε = 1 mm / 1 mrad) or failed keep their state; the loop ends
early once every pair has stopped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se2
from ..core.scan import LaserModel, Scan

Tensor = torch.Tensor

MAX_ITERATIONS = 10
EPSILON_XY = 0.001            # [m]
EPSILON_THETA = 0.001         # [rad]
MAX_CORR_DIST = 2.0           # [m]
OUTLIER_MAX_PERC = 0.95
ADAPTIVE_ORDER = 0.7
ADAPTIVE_MULT = 2.0
SENSOR_SIGMA = 0.04           # [m]
SYNC_EVERY = 4                # iterations between reads of the batch's flags


class PlIcpResult(NamedTuple):
    pose: Tensor      # [B, 3]
    cov: Tensor       # [B, 3, 3]
    err: Tensor       # [B] mean squared point-to-line residual
    fail: Tensor      # [B] bool
    n_valid: Tensor   # [B] int32


def _two_nearest(model: LaserModel, ref_pts: Tensor, ref_bad: Tensor, q: Tensor):
    """For each query point ``q [B, N, 2]`` the two nearest good reference
    points within a ±W bearing band. Returns ``(j1, j2, d1)`` ``[B, N]``."""
    n, w = model.n_beams, model.window
    dev = q.device
    idx = torch.arange(n, device=dev)[:, None] + torch.arange(-w, w + 1, device=dev)[None, :]
    inb = (idx >= 0) & (idx < n)
    idx_c = idx.clamp(0, n - 1)                                    # [N, K]
    ok = inb & ~ref_bad[..., idx_c]                                # [B, N, K]
    diff = q[..., None, :] - ref_pts[:, idx_c]                     # [B, N, K, 2]
    d2 = torch.where(ok, torch.sum(diff * diff, dim=-1), torch.inf)
    k1 = torch.argmin(d2, dim=-1)                                  # first on ties
    d1 = torch.gather(d2, -1, k1[..., None])[..., 0]
    k2 = torch.argmin(d2.scatter(-1, k1[..., None], torch.inf), dim=-1)
    rows = torch.arange(n, device=dev)
    return idx_c[rows, k1], idx_c[rows, k2], torch.sqrt(d1)


def _take_pts(pts: Tensor, idx: Tensor) -> Tensor:
    return torch.gather(pts, 1, idx[..., None].expand(-1, -1, 2))


def match_plicp(
    model: LaserModel,
    ref: Scan,
    cur: Scan,
    init_pose: Tensor | None = None,
    info: dict | None = None,
) -> PlIcpResult:
    """PL-ICP of ``cur`` onto ``ref`` (preprocessed scans ``[B, N]``,
    ``init_pose [B, 3]``). With a dict ``info``, ``info["iters"]`` holds
    each pair's iteration count ``[B]``."""
    dtype, dev = cur.ranges.dtype, cur.ranges.device
    b, n = cur.ranges.shape
    pose = (torch.zeros(b, 3, dtype=dtype, device=dev) if init_pose is None
            else init_pose.to(dtype).clone())
    fi = model.bearings(dtype, dev)
    co_fi, si_fi = torch.cos(fi), torch.sin(fi)
    cur_pts = torch.stack([cur.ranges * co_fi, cur.ranges * si_fi], dim=-1)
    ref_pts = torch.stack([ref.ranges * co_fi, ref.ranges * si_fi], dim=-1)
    cur_ok = ~cur.bad
    eye = torch.eye(3, dtype=dtype, device=dev)

    it = torch.zeros(b, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    fail = torch.zeros(b, dtype=torch.bool, device=dev)
    err = torch.full((b,), 1e6, dtype=dtype, device=dev)
    n_valid = torch.zeros(b, dtype=torch.int32, device=dev)
    hess = eye.expand(b, 3, 3).clone()

    for k in range(MAX_ITERATIONS):
        frozen = done | fail
        if k % SYNC_EVERY == 0 and k and bool(frozen.all()):
            break
        q = se2.transform_points(pose, cur_pts)                    # [B, N, 2]
        j1, j2, d1 = _two_nearest(model, ref_pts, ref.bad, q)
        p1 = _take_pts(ref_pts, j1)
        seg = _take_pts(ref_pts, j2) - p1
        seg_len = torch.sqrt(torch.sum(seg * seg, dim=-1))
        # The normal of the (j1, j2) line.
        safe = torch.where(seg_len < 1e-9, 1.0, seg_len)
        nx, ny = -seg[..., 1] / safe, seg[..., 0] / safe
        resid = nx * (q[..., 0] - p1[..., 0]) + ny * (q[..., 1] - p1[..., 1])
        valid = cur_ok & torch.isfinite(d1) & (d1 < MAX_CORR_DIST) & (seg_len > 1e-9)

        # Adaptive trim: mult × the order-quantile of |resid|, capped at
        # the max-percentile cut.
        a = torch.where(valid, torch.abs(resid), torch.inf)
        srt = torch.sort(a, dim=-1, stable=True).values
        nv = torch.sum(valid, dim=-1).to(dtype)
        qi = (nv * ADAPTIVE_ORDER).to(torch.int32).clamp(0, n - 1).long()
        pi = ((nv * OUTLIER_MAX_PERC).to(torch.int32) - 1).clamp(0, n - 1).long()
        thresh = torch.minimum(torch.gather(srt, -1, qi[:, None]) * ADAPTIVE_MULT,
                               torch.gather(srt, -1, pi[:, None]))
        keep = valid & (torch.abs(resid) <= thresh)
        wk = keep.to(dtype)
        m = torch.sum(wk, dim=-1)
        fail_n = m < model.min_valid_points

        # Linearized point-to-line GN step: the Jacobian of
        # n·(R p + t - p1) in (dx, dy, dθ), rotation about the origin.
        th = pose[:, 2:3]
        st, ct = torch.sin(th), torch.cos(th)
        dqx = -cur_pts[..., 0] * st - cur_pts[..., 1] * ct
        dqy = cur_pts[..., 0] * ct - cur_pts[..., 1] * st
        J = torch.stack([nx, ny, nx * dqx + ny * dqy], dim=-1)     # [B, N, 3]
        Jw = J * wk[..., None]
        H = Jw.transpose(1, 2) @ J                                 # [B, 3, 3]
        g = (Jw.transpose(1, 2) @ resid[..., None])[..., 0]        # [B, 3]
        delta = -torch.linalg.solve_ex(H + 1e-9 * eye, g[..., None])[0][..., 0]
        delta = torch.where(fail_n[:, None], 0.0, delta)
        pose_n = torch.stack([pose[:, 0] + delta[:, 0], pose[:, 1] + delta[:, 1],
                              se2.normalize_angle(pose[:, 2] + delta[:, 2])], dim=-1)
        done_n = ((torch.abs(delta[:, 0]) < EPSILON_XY) & (torch.abs(delta[:, 1]) < EPSILON_XY)
                  & (torch.abs(delta[:, 2]) < EPSILON_THETA))
        err_n = torch.sum(torch.where(keep, resid * resid, 0.0), dim=-1) / torch.clamp(m, min=1.0)

        pose = torch.where(frozen[:, None], pose, pose_n)
        it = torch.where(frozen, it, it + 1)
        done = torch.where(frozen, done, done_n)
        err = torch.where(frozen | fail_n, err, err_n)
        hess = torch.where((frozen | fail_n)[:, None, None], hess, H)
        n_valid = torch.where(frozen, n_valid, m.to(torch.int32))
        fail = torch.where(frozen, fail, fail | fail_n)

    # Covariance ≈ σ² (JᵀJ)⁻¹ from the final normal matrix.
    sigma2 = torch.clamp(err, min=SENSOR_SIGMA ** 2)
    cov = sigma2[:, None, None] * torch.linalg.inv_ex(hess + 1e-6 * eye)[0]
    if info is not None:
        info["iters"] = it
    return PlIcpResult(pose=pose, cov=cov, err=err, fail=fail, n_valid=n_valid)
