"""Polar Scan Matching (PSM), batched over pairs (port of ``ops/psm.py``).

Each loop step runs one orientation search (a ``[2W+1]``-shift masked
cross-correlation with parabolic refinement) and one closed-form
Cauchy-weighted translation step. Pairs that converged or failed keep
their state (a masked fixed-trip loop), which is the reference's early
exit. :func:`match_psm` counts the iterations each pair takes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se2
from ..core.scan import LaserModel, Scan
from .project import Projection, scan_project, scan_project_banded

Tensor = torch.Tensor

# --- constants (src/zhpsm/PolarParameter.h:12-24, cm→m where relevant) ---
MAX_ERROR = 1.0                  # PM_MAX_ERROR = 100 cm
WEIGHTING_FACTOR = 0.70 * 0.70   # (0.70 m)²
CHANGE_WEIGHT_ITER = 10          # PM_CHANGE_WEIGHT_ITER (reference iters)
STOP_COND = 0.4                  # on 100·(|dx|+|dy|) + |dθ|
MAX_ITER = 30                    # PM_MAX_ITER (reference iterations)
LARGE_ERR = 100.0                # orientation-search sentinel


class MatchResult(NamedTuple):
    """Common result of every matcher."""

    pose: Tensor      # [..., 3] relative pose of cur in ref frame (m, rad)
    err: Tensor       # [...] average residual (meters)
    fail: Tensor      # [...] bool — degenerate geometry, do not trust pose
    n_valid: Tensor   # [...] int32 — points supporting the estimate
    iters: Tensor | None = None   # [...] int32 — solver iterations taken


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """``x[..., idx]`` for a batched index ``idx [...]`` (one per row)."""
    return torch.gather(x, -1, idx[..., None])[..., 0]


def orientation_search(
    model: LaserModel, ref: Scan, proj: Projection
) -> tuple[Tensor, Tensor]:
    """One orientation-alignment step; returns ``(dtheta, fail)``.

    Shifting the projected scan by ``di`` bins approximates rotating it by
    ``di·dfi``; the shift with the least mean absolute range residual
    wins (first index on ties), refined by a parabola through it and its
    neighbours.
    """
    n, w = model.n_beams, model.window
    dev = ref.ranges.device
    di = torch.arange(-w, w + 1, device=dev)
    idx = torch.arange(n, device=dev)[None, :] + di[:, None]     # [K, N]
    inb = (idx >= 0) & (idx < n)
    idx_c = idx.clamp(0, n - 1)

    ref_r = ref.ranges[..., idx_c]                               # [..., K, N]
    ref_bad = ref.bad[..., idx_c]
    valid = inb & ~proj.bad[..., None, :] & ~ref_bad
    delta = torch.abs(proj.new_r[..., None, :] - ref_r)

    cnt = torch.sum(valid, dim=-1, dtype=torch.int32)
    e = torch.sum(torch.where(valid, delta, 0.0), dim=-1)
    err = torch.where(cnt > 0, e / cnt.clamp(min=1), LARGE_ERR)  # [..., K]

    imin = torch.argmin(err, dim=-1)
    emin = _take(err, imin)
    fail = emin >= LARGE_ERR
    dth = (imin - w).to(err.dtype) * model.dfi

    k = 2 * w + 1
    em1 = _take(err, (imin - 1).clamp(0, k - 1))
    ep1 = _take(err, (imin + 1).clamp(0, k - 1))
    curv = em1 + ep1 - 2.0 * emin
    interior = (imin >= 1) & (imin < k - 1)
    ok = interior & (torch.abs(curv) > 1e-4) & (em1 > emin) & (ep1 > emin)
    d = torch.where(ok, (em1 - ep1) / torch.where(ok, curv, 1.0) / 2.0, 0.0)
    dth = dth + torch.where(torch.abs(d) < 1.0, d, 0.0) * model.dfi
    return dth, fail


def translation_estimation(
    model: LaserModel, ref: Scan, proj: Projection, C: Tensor
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """One weighted-least-squares translation step; returns
    ``(dx, dy, avg_err, fail)``."""
    fi = model.bearings(proj.new_r.dtype, proj.new_r.device)
    co, si = torch.cos(fi), torch.sin(fi)
    dr = ref.ranges - proj.new_r
    valid = (
        ~ref.bad
        & ~proj.bad
        & (proj.new_r < model.max_range)
        & (proj.new_r > model.min_range)
        & (torch.abs(dr) < MAX_ERROR)
    )
    wgt = torch.where(valid, C[..., None] / (dr * dr + C[..., None]), 0.0)
    n = torch.sum(valid, dim=-1, dtype=torch.int32)

    hw1 = torch.sum(wgt * co * dr, dim=-1)
    hw2 = torch.sum(wgt * si * dr, dim=-1)
    h11 = torch.sum(wgt * co * co, dim=-1)
    h12 = torch.sum(wgt * co * si, dim=-1)
    h22 = torch.sum(wgt * si * si, dim=-1)

    det = h11 * h22 - h12 * h12
    fail = (n < model.min_valid_points) | (det < 1e-3)
    det_safe = torch.where(fail, 1.0, det)
    dx = (h22 * hw1 - h12 * hw2) / det_safe
    dy = (-h12 * hw1 + h11 * hw2) / det_safe
    # The reference averages |dr| over *all* beams (empty bins included)
    # but divides by the valid count — kept for parity.
    avg_err = torch.sum(torch.abs(dr), dim=-1) / n.clamp(min=1)
    return dx, dy, avg_err, fail


def _small_step(small_cnt: Tensor, corr: Tensor) -> Tensor:
    measure = 100.0 * (torch.abs(corr[..., 0]) + torch.abs(corr[..., 1])) + torch.abs(corr[..., 2])
    return torch.where(measure < STOP_COND, small_cnt + 1, 0)


def match_psm(
    model: LaserModel,
    ref: Scan,
    cur: Scan,
    init_pose: Tensor | None = None,
    banded: bool = False,
) -> MatchResult:
    """Match ``cur`` against ``ref`` (preprocessed scans ``[B, N]``);
    returns the relative pose of ``cur`` in ``ref``'s frame, ``[B, 3]``.

    One loop step = one orientation + one translation update (two
    reference iterations); the stop counter advances at both half-steps.
    The loop ends early once every pair has converged or failed.

    ``banded=True`` projects with :func:`.project.scan_project_banded`
    (plain PyTorch on every device; the fused kernel projects densely).
    """
    project = scan_project_banded if banded else scan_project
    dtype, dev = cur.ranges.dtype, cur.ranges.device
    shape = cur.ranges.shape[:-1]
    if init_pose is None:
        init_pose = torch.zeros(shape + (3,), dtype=dtype, device=dev)
    pose = init_pose.to(dtype)
    corr = torch.full(shape + (3,), 1e6, dtype=dtype, device=dev)
    C = torch.full(shape, WEIGHTING_FACTOR, dtype=dtype, device=dev)
    small = torch.zeros(shape, dtype=torch.int32, device=dev)
    fail = torch.zeros(shape, dtype=torch.bool, device=dev)
    avg = torch.full(shape, LARGE_ERR, dtype=dtype, device=dev)
    iters = torch.zeros(shape, dtype=torch.int32, device=dev)

    for it in range(MAX_ITER // 2):
        done = (small >= 3) | fail
        if bool(done.all()):
            break
        iters = iters + (~done).to(torch.int32)
        # -- orientation half-step --
        small_n = _small_step(small, corr)
        proj = project(model, cur, pose)
        dth, fail_o = orientation_search(model, ref, proj)
        ath = pose[..., 2] + dth
        small_n = _small_step(
            small_n, torch.stack([corr[..., 0], corr[..., 1], dth], dim=-1)
        )
        # -- translation half-step --
        C_n = C / 50.0 if it * 2 + 1 == CHANGE_WEIGHT_ITER + 1 else C
        proj = project(
            model, cur, torch.stack([pose[..., 0], pose[..., 1], ath], dim=-1)
        )
        dx, dy, avg_n, fail_t = translation_estimation(model, ref, proj, C_n)
        fail_n = fail_o | fail_t
        dx = torch.where(fail_n, 0.0, dx)
        dy = torch.where(fail_n, 0.0, dy)
        pose_n = torch.stack([pose[..., 0] + dx, pose[..., 1] + dy, ath], dim=-1)
        corr_n = torch.stack([dx, dy, dth], dim=-1)
        avg_n = torch.where(fail_n, avg, avg_n)

        keep = done[..., None]
        pose = torch.where(keep, pose, pose_n)
        corr = torch.where(keep, corr, corr_n)
        C = torch.where(done, C, C_n)
        small = torch.where(done, small, small_n)
        fail = torch.where(done, fail, fail_n)
        avg = torch.where(done, avg, avg_n)

    pose = torch.cat([pose[..., :2], se2.normalize_angle(pose[..., 2:])], dim=-1)
    return MatchResult(
        pose=pose,
        err=avg,
        fail=fail,
        n_valid=torch.zeros(shape, dtype=torch.int32, device=dev),
        iters=iters,
    )


def error_index(
    model: LaserModel, ref: Scan, cur: Scan, rel_pose: Tensor
) -> tuple[Tensor, Tensor, Tensor]:
    """Post-match alignment quality (pm_error_index2): project ``cur`` at
    ``rel_pose`` onto ``ref`` and average squared beam-direction residual
    components over beams agreeing within 1 m. Returns ``(err_x, err_y,
    n)`` in m²; ``1e6`` where no beam overlaps."""
    proj = scan_project(model, cur, rel_pose)
    fi = model.bearings(cur.ranges.dtype, cur.ranges.device)
    delta = torch.abs(proj.new_r - ref.ranges)
    valid = ~proj.bad & ~ref.bad & (delta < 1.0)
    n = torch.sum(valid, dim=-1, dtype=torch.int32)
    nf = n.clamp(min=1).to(delta.dtype)
    ex = torch.sum(torch.where(valid, (delta * torch.cos(fi)) ** 2, 0.0), dim=-1) / nf
    ey = torch.sum(torch.where(valid, (delta * torch.sin(fi)) ** 2, 0.0), dim=-1) / nf
    none = n == 0
    return torch.where(none, 1e6, ex), torch.where(none, 1e6, ey), n
