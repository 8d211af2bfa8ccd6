"""Polar-windowed trimmed ICP, batched over pairs (port of ``ops/icp.py``).

- the correspondence search, restricted to a ±W bearing-index band, is a
  gathered ``[B, N, 2W]`` distance matrix and an argmin;
- the worst 20 % of the matches are trimmed at an exact quantile (a sort);
- point-to-segment refinement projects each matched point onto the two
  reference segments adjacent to its match;
- the pose update is the closed-form 2D rigid alignment about the
  current laser center;
- a pair stops after three small corrections in a row or when it fails;
  stopped pairs keep their state (a masked loop of at most
  ``MAX_ITER_ICP`` iterations), and the loop ends early once every pair
  has stopped: the batch's flags are read on the host every
  ``SYNC_EVERY`` iterations, never per pair.
"""

from __future__ import annotations

import math

import torch

from ..core import se2
from ..core.scan import LaserModel, Scan
from .project import scan_project
from .psm import MAX_ERROR, MatchResult

Tensor = torch.Tensor

MAX_ITER_ICP = 60       # iteration cap
STOP_COND_ICP = 0.1     # on 100·(|dx|+|dy|) + deg(|dθ|)
TRIM_FRACTION = 0.2     # worst 20 % of matches dropped
SYNC_EVERY = 8          # iterations between reads of the batch's done flags


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _point_segment_projection(p0: Tensor, p1: Tensor, q: Tensor):
    """Project points ``q [..., 2]`` onto segments ``p0→p1``. Returns
    ``(proj [..., 2], dist [...], inside [...])``: ``inside`` is false
    where the projection falls outside the segment."""
    d = p1 - p0
    len2 = torch.sum(d * d, dim=-1)
    t = torch.sum((q - p0) * d, dim=-1) / torch.where(len2 < 1e-12, 1.0, len2)
    inside = (t >= 0.0) & (t <= 1.0) & (len2 >= 1e-12)
    proj = p0 + t[..., None] * d
    return proj, _norm(q - proj), inside


def _correspondences(model: LaserModel, ref: Scan, ref_x: Tensor, ref_y: Tensor,
                     nx: Tensor, ny: Tensor, cur_ok: Tensor):
    """Banded nearest-neighbour search: per current beam ``i`` the nearest
    good reference beam in ``[i-W, i+W)``. Returns ``(j_idx, dist, valid)``
    ``[B, N]``; ``dist`` is inf where not valid."""
    n, w = model.n_beams, model.window
    dev = nx.device
    idx = torch.arange(n, device=dev)[:, None] + torch.arange(-w, w, device=dev)[None, :]
    inb = (idx >= 0) & (idx < n)
    idx_c = idx.clamp(0, n - 1)                                    # [N, 2W]
    cand_ok = inb & ~ref.bad[..., idx_c]                           # [B, N, 2W]
    dx = nx[..., None] - ref_x[..., idx_c]
    dy = ny[..., None] - ref_y[..., idx_c]
    d2 = torch.where(cand_ok, dx * dx + dy * dy, torch.inf)
    k = torch.argmin(d2, dim=-1)                                   # first on ties
    best = torch.gather(d2, -1, k[..., None])[..., 0]
    j_idx = idx_c[torch.arange(n, device=dev), k]
    dist = torch.sqrt(best)
    valid = cur_ok & torch.isfinite(best) & (dist < MAX_ERROR)
    return j_idx, torch.where(valid, dist, torch.inf), valid


def _take_pts(pts: Tensor, idx: Tensor) -> Tensor:
    """``pts [B, N, 2]`` at ``idx [B, N]``."""
    return torch.gather(pts, 1, idx[..., None].expand(-1, -1, 2))


def match_icp(
    model: LaserModel,
    ref: Scan,
    cur: Scan,
    init_pose: Tensor | None = None,
    info: dict | None = None,
) -> MatchResult:
    """Polar-windowed trimmed ICP of ``cur`` onto ``ref`` (preprocessed
    scans ``[B, N]``, ``init_pose [B, 3]``); returns the relative pose of
    ``cur`` in ``ref``'s frame. With a dict ``info``, ``info["iters"]``
    holds each pair's iteration count ``[B]`` (int32, on the device)."""
    dtype, dev = cur.ranges.dtype, cur.ranges.device
    b, n = cur.ranges.shape
    pose = (torch.zeros(b, 3, dtype=dtype, device=dev) if init_pose is None
            else init_pose.to(dtype).clone())
    fi = model.bearings(dtype, dev)
    co_fi, si_fi = torch.cos(fi), torch.sin(fi)
    cx, cy = cur.ranges * co_fi, cur.ranges * si_fi
    ref_x, ref_y = ref.ranges * co_fi, ref.ranges * si_fi
    ref_pts = torch.stack([ref_x, ref_y], dim=-1)                  # [B, N, 2]
    ar = torch.arange(n, device=dev)
    jm1, jp1 = (ar - 1).clamp(min=0), (ar + 1).clamp(max=n - 1)

    corr = torch.full((b, 3), 1e6, dtype=dtype, device=dev)
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    small = torch.zeros(b, dtype=torch.int32, device=dev)
    fail = torch.zeros(b, dtype=torch.bool, device=dev)
    err = torch.full((b,), 1e6, dtype=dtype, device=dev)
    n_valid = torch.zeros(b, dtype=torch.int32, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    for k in range(MAX_ITER_ICP):
        done = (small >= 3) | fail
        if k % SYNC_EVERY == 0 and k and bool(done.all()):
            break
        measure = (100.0 * (torch.abs(corr[:, 0]) + torch.abs(corr[:, 1]))
                   + torch.abs(corr[:, 2]) * 180.0 / math.pi)
        small_n = torch.where(measure < STOP_COND_ICP, small + 1, 0)

        ax, ay, ath = pose[:, 0:1], pose[:, 1:2], pose[:, 2:3]
        # The projection supplies the per-bin validity that gates the
        # current points.
        proj = scan_project(model, cur, pose)
        co, si = torch.cos(ath), torch.sin(ath)
        nx = cx * co - cy * si + ax
        ny = cx * si + cy * co + ay

        j_idx, dist, valid = _correspondences(model, ref, ref_x, ref_y, nx, ny, ~proj.bad)
        n_match = torch.sum(valid, dim=-1, dtype=torch.int32)
        fail_n = n_match < model.min_valid_points

        # Exact 80 % trim: keep the matches below the (1 - TRIM) quantile.
        sorted_d = torch.sort(dist, dim=-1, stable=True).values    # invalid = inf, at the end
        n_keep = (n_match.to(torch.float32) * (1.0 - TRIM_FRACTION)).to(torch.int32).clamp(min=1)
        thresh = torch.gather(sorted_d, -1, (n_keep - 1).clamp(0, n - 1)[:, None].long())
        keep = valid & (dist <= thresh)

        # Point-to-segment refinement around each matched reference point.
        q = torch.stack([nx, ny], dim=-1)                          # [B, N, 2]
        pj = _take_pts(ref_pts, j_idx)
        d0 = _norm(q - pj)
        proj1, d1, in1 = _point_segment_projection(_take_pts(ref_pts, jm1[j_idx]), pj, q)
        proj2, d2, in2 = _point_segment_projection(pj, _take_pts(ref_pts, jp1[j_idx]), q)
        use1 = in1 & (j_idx > 0) & (d1 < d0)
        tgt = torch.where(use1[..., None], proj1, pj)
        dbest = torch.where(use1, d1, d0)
        use2 = in2 & (j_idx < n - 1) & (d2 < dbest)
        tgt = torch.where(use2[..., None], proj2, tgt)
        dbest = torch.where(use2, d2, dbest)

        # Closed-form rigid update about the laser center.
        wk = keep.to(dtype)
        m = torch.maximum(torch.sum(wk, dim=-1), one)
        mean_p = torch.sum(q * wk[..., None], dim=1) / m[:, None]
        mean_t = torch.sum(tgt * wk[..., None], dim=1) / m[:, None]
        dp = (q - mean_p[:, None]) * wk[..., None]
        dt = tgt - mean_t[:, None]
        sxx = torch.sum(dp[..., 0] * dt[..., 0], dim=-1)
        sxy = torch.sum(dp[..., 0] * dt[..., 1], dim=-1)
        syx = torch.sum(dp[..., 1] * dt[..., 0], dim=-1)
        syy = torch.sum(dp[..., 1] * dt[..., 1], dim=-1)
        dth = torch.atan2(sxy - syx, sxx + syy)
        cd, sd = torch.cos(dth), torch.sin(dth)
        ax, ay, ath = ax[:, 0], ay[:, 0], ath[:, 0]
        dx = mean_t[:, 0] - ax - (cd * (mean_p[:, 0] - ax) - sd * (mean_p[:, 1] - ay))
        dy = mean_t[:, 1] - ay - (sd * (mean_p[:, 0] - ax) + cd * (mean_p[:, 1] - ay))
        dx, dy, dth = (torch.where(fail_n, 0.0, v) for v in (dx, dy, dth))
        pose_n = torch.stack([ax + dx, ay + dy, se2.normalize_angle(ath + dth)], dim=-1)
        err_n = torch.sum(torch.where(keep, dbest, 0.0), dim=-1) / m

        pose = torch.where(done[:, None], pose, pose_n)
        corr = torch.where(done[:, None], corr, torch.stack([dx, dy, dth], dim=-1))
        it = torch.where(done, it, it + 1)
        small = torch.where(done, small, small_n)
        err = torch.where(done | fail_n, err, err_n)
        fail = torch.where(done, fail, fail | fail_n)
        n_valid = torch.where(done, n_valid, n_match)

    if info is not None:
        info["iters"] = it
    return MatchResult(pose=pose, err=err, fail=fail, n_valid=n_valid)
