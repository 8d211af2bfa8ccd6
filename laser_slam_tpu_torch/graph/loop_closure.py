"""Loop-closure detection: batched gating and batched verification (port
of ``graph/loop_closure.py``).

- geometric gates (center distance within a drift-sized radius, optional
  bounding-box overlap) are evaluated for **all** anchor pairs at once
  as a dense masked matrix;
- candidate verification is batched over the candidates: the init-free
  correlative verifier (an exhaustive coarse correlative search against
  a wide reference cloud, a per-peak ICP polish, a reciprocal check), or
  trimmed point ICP from the current estimate (:func:`verify_loops`), or
  feature RANSAC (:func:`verify_loops_features`);
- pairwise-consistent-measurement pruning (PCM) keeps the loops whose
  odometry cycles agree with enough others; :func:`consistency_prune` is
  the simpler vote over implied pose corrections.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import se2
from ..core.scan import LaserModel, Scan
from ..ops.correlative import build_likelihood_grid_points, correlative_top_peaks
from ..ops.icp_points import PointIcpResult, match_icp_points, scan_to_points

Tensor = torch.Tensor

LOOP_RADIUS = 2.0          # [m] constant-covariance search radius
BBOX_OVERLAP_MIN = 0.4     # bounding-box overlap threshold
MIN_INDEX_GAP = 2          # skip adjacent submaps
MAX_TRANSFORM_DELTA = 1.5  # [m] bound on the correction vs the estimate
MAX_ANGLE_DELTA = 0.8      # [rad] bound on the correction vs the estimate
QUALITY_MIN = 0.45         # ICP goodness floor
MATCH_ERR_MAX = 0.12       # [m] mean matched-point distance gate


class LoopCandidates(NamedTuple):
    src: Tensor    # [C] int64 anchor indices (earlier scan)
    dst: Tensor    # [C] int64 anchor indices (later scan)
    valid: Tensor  # [C] bool


class VerifiedLoops(NamedTuple):
    src: Tensor
    dst: Tensor
    rel: Tensor       # [C, 3] measured relative pose src→dst
    quality: Tensor   # [C] matched-point fraction
    accept: Tensor    # [C] bool — strict tier (solve-grade edges)
    tentative: Tensor | None = None  # [C] bool — loose tier: correct-
    #   looking matches below the strict gates; only usable after a
    #   residual-under-solution promotion check (see _solve_with_bank)
    diag: dict | None = None  # per-gate masks and scores (tuning, tests)
    cov: Tensor | None = None  # [C, 3, 3] Censi covariance of ``rel``
    #   (from the polish ICP)


def _norm2(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def submap_bboxes(model: LaserModel, scans: Scan, poses: Tensor) -> tuple[Tensor, Tensor]:
    """World-frame AABBs of each scan's valid beam endpoints under
    ``poses [T, 3]``: ``(lo [T, 2], hi [T, 2])``."""
    fi = model.bearings(scans.ranges.dtype, scans.ranges.device)
    ok = ~scans.bad & (scans.ranges < model.max_range)
    ang = poses[:, 2:3] + fi[None, :]
    ex = poses[:, 0:1] + scans.ranges * torch.cos(ang)
    ey = poses[:, 1:2] + scans.ranges * torch.sin(ang)
    big = 1e9
    lo = torch.stack([torch.where(ok, ex, big).amin(dim=1), torch.where(ok, ey, big).amin(dim=1)], -1)
    hi = torch.stack([torch.where(ok, ex, -big).amax(dim=1), torch.where(ok, ey, -big).amax(dim=1)], -1)
    return lo, hi


def drift_radius_matrix(
    n: int,
    r0: float,
    rate: float | Tensor,
    rmax: float,
    dtype=torch.float32,
    device=None,
) -> Tensor:
    """``[A, A]`` per-pair loop search radii that grow with the odometry
    path length between the anchors.

    The relative-pose uncertainty of anchors ``(i, j)`` accumulates over
    the ``|j - i|`` odometry steps between them, so a revisit after a
    long excursion must be searched in a drift-sized window while nearby
    anchors keep a tight gate: a linear drift-rate model
    ``r = r0 + rate·gap`` clipped to ``[r0, rmax]``.
    """
    ii = torch.arange(n, dtype=dtype, device=device)
    gap = torch.abs(ii[None, :] - ii[:, None])
    return torch.clamp(r0 + rate * gap, min=r0, max=rmax)


def gate_matrix(
    centers: Tensor,
    bbox_lo: Tensor | None = None,
    bbox_hi: Tensor | None = None,
    radius: float | Tensor = LOOP_RADIUS,
    min_gap: int = MIN_INDEX_GAP,
    overlap_min: float | None = BBOX_OVERLAP_MIN,
) -> Tensor:
    """``[A, A]`` bool: entry (i, j) true iff anchors i<j are loop-closure
    candidates under the distance + bbox-overlap gates.

    ``radius`` may be a scalar or a per-pair ``[A, A]`` matrix (see
    :func:`drift_radius_matrix`). With a drift-sized radius the estimated
    bboxes of true revisits may not overlap at all, so the overlap test
    dilates each box by the per-pair radius; ``overlap_min=None`` skips
    the overlap gate.
    """
    a = centers.shape[0]
    radius = torch.as_tensor(radius, dtype=centers.dtype, device=centers.device)
    d2 = torch.sum((centers[:, None, :] - centers[None, :, :]) ** 2, dim=-1)
    near = d2 <= radius * radius
    ii = torch.arange(a, device=centers.device)
    gate = near & ((ii[None, :] - ii[:, None]) > min_gap)          # j - i > gap

    if overlap_min is not None and bbox_lo is not None:
        dil = torch.broadcast_to(radius, (a, a))[..., None]
        lo_j, hi_j = bbox_lo[None, :, :], bbox_hi[None, :, :]
        inter_lo = torch.maximum(bbox_lo[:, None, :], lo_j) - 0.5 * dil
        inter_hi = torch.minimum(bbox_hi[:, None, :], hi_j) + 0.5 * dil
        inter = torch.clamp(inter_hi - inter_lo, min=0.0)
        area_j = torch.prod(torch.clamp(hi_j - lo_j, min=1e-6), dim=-1)
        gate = gate & ((inter[..., 0] * inter[..., 1] / area_j) >= overlap_min)
    return gate


def select_candidates(
    gate: Tensor,
    centers: Tensor,
    max_pairs: int,
    radius: Tensor | None = None,
    per_dst: int = 0,
    boost: Tensor | None = None,
) -> LoopCandidates:
    """Pick up to ``max_pairs`` gated pairs, fixed shape.

    Pairs are ranked by center distance normalized by the per-pair
    search ``radius`` (a pair 6 m apart after a 300-step excursion
    outranks one 3 m apart after 30 steps); ``boost`` is a bonus for
    pairs that would constrain so-far-unconstrained regions. With
    ``per_dst > 0`` each destination anchor keeps at most that many
    source candidates before the global cut, which spreads the fixed
    verification budget over the whole trajectory.

    Ties: the per-destination cut keeps every pair at or above the
    ``per_dst``-th best value, so the order among equals plays no part
    there; the global cut is a stable descending sort, so among equal
    scores (and among the ``-inf`` of ungated pairs that fill an
    underfull budget) the lower flat index ``src·A + dst`` comes first.
    """
    a = gate.shape[0]
    d2 = torch.sum((centers[:, None, :] - centers[None, :, :]) ** 2, dim=-1)
    if radius is not None:
        norm = torch.sqrt(d2) / torch.clamp(radius, min=1e-6)
    else:
        norm = d2
    if boost is not None:
        norm = norm - boost
    score = torch.where(gate, -norm, -torch.inf)

    if per_dst > 0:
        score_t = score.T                                          # [dst, src]
        kth = torch.topk(score_t, min(per_dst, a), dim=-1).values[:, -1]
        score = torch.where((score_t >= kth[:, None]).T, score, -torch.inf)

    srt = torch.sort(score.reshape(-1), descending=True, stable=True)
    vals, idx = srt.values[:max_pairs], srt.indices[:max_pairs]
    return LoopCandidates(src=idx // a, dst=idx % a, valid=torch.isfinite(vals))


def icp_both_ways(ref_pts, ref_ok, cur_pts, cur_ok, init, max_corr):
    """Trimmed point ICP of every pair forward (``cur`` onto ``ref`` from
    ``init``) and backward (``ref`` onto ``cur`` from its inverse), the
    two directions as one batch of ``2C``: ``(fwd, bwd)``."""
    c = init.shape[0]
    res = match_icp_points(
        torch.cat([ref_pts, cur_pts]), torch.cat([ref_ok, cur_ok]),
        torch.cat([cur_pts, ref_pts]), torch.cat([cur_ok, ref_ok]),
        torch.cat([init, se2.inverse(init)]), max_corr=max_corr)
    return PointIcpResult(*(x[:c] for x in res)), PointIcpResult(*(x[c:] for x in res))


def icp_loop_gates(valid: Tensor, init: Tensor, fwd: PointIcpResult, bwd: PointIcpResult) -> Tensor:
    """Acceptance of ICP-verified loops: both legs converged, the legs
    invert each other (a reciprocal cycle under 10 cm / 0.035 rad:
    perceptual aliases rarely reciprocate), a correction vs the estimate
    ``init`` within ``MAX_TRANSFORM_DELTA`` / ``MAX_ANGLE_DELTA``, and
    the forward match's goodness and mean error."""
    cycle = se2.compose(fwd.pose, bwd.pose)
    reciprocal = (_norm2(cycle[:, :2]) < 0.10) & (
        torch.abs(se2.normalize_angle(cycle[:, 2])) < 0.035)
    delta = se2.relative(init, fwd.pose)
    small_corr = (_norm2(delta[:, :2]) < MAX_TRANSFORM_DELTA) & (
        torch.abs(se2.normalize_angle(delta[:, 2])) < MAX_ANGLE_DELTA)
    return (valid & ~fwd.fail & ~bwd.fail & reciprocal & small_corr
            & (fwd.goodness >= QUALITY_MIN) & (fwd.err < MATCH_ERR_MAX))


def verify_loops(
    model: LaserModel,
    anchor_scans: Scan,
    anchor_poses: Tensor,
    cand: LoopCandidates,
    max_corr: float = 1.5,
) -> VerifiedLoops:
    """Verify the candidates with free-form trimmed point ICP from the
    current pose estimates, scan against scan, forward and backward in
    one batch (:func:`icp_both_ways`, :func:`icp_loop_gates`)."""
    ref_pts, ref_ok = scan_to_points(model, Scan(*(x[cand.src] for x in anchor_scans)))
    cur_pts, cur_ok = scan_to_points(model, Scan(*(x[cand.dst] for x in anchor_scans)))
    init = se2.relative(anchor_poses[cand.src], anchor_poses[cand.dst])
    fwd, bwd = icp_both_ways(ref_pts, ref_ok, cur_pts, cur_ok, init, max_corr)
    accept = icp_loop_gates(cand.valid, init, fwd, bwd)
    rel = torch.where(accept[:, None], torch.nan_to_num(fwd.pose), 0.0)
    return VerifiedLoops(src=cand.src, dst=cand.dst, rel=rel, quality=fwd.goodness, accept=accept)


def consistency_prune(loops: VerifiedLoops, anchor_poses: Tensor) -> Tensor:
    """Keep the loops consistent with enough others: each accepted loop
    implies a correction of its dst anchor; loops whose corrections agree
    (within 1 m / 0.3 rad) vote for each other, and a loop needs
    ``min(accepted, 3)`` votes, itself included. Corrections are local to
    a revisit, so an absolute quorum keeps every real cluster and drops
    isolated spurious matches."""
    pred_dst = se2.compose(anchor_poses[loops.src], loops.rel)
    corr = torch.cat([
        pred_dst[:, :2] - anchor_poses[loops.dst, :2],
        se2.normalize_angle(pred_dst[:, 2:3] - anchor_poses[loops.dst, 2:3]),
    ], dim=-1)
    dt = _norm2(corr[:, None, :2] - corr[None, :, :2])
    da = torch.abs(se2.normalize_angle(corr[:, None, 2] - corr[None, :, 2]))
    agree = (dt < 1.0) & (da < 0.3) & loops.accept[None, :] & loops.accept[:, None]
    votes = torch.sum(agree, dim=1)
    return loops.accept & (votes >= torch.clamp(torch.sum(loops.accept), max=3))


def pcm_cycle_errors(
    src: Tensor, dst: Tensor, rel: Tensor, odo_anchor_poses: Tensor
) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """Pairwise loop-vs-loop cycle errors through the raw odometry:
    ``(et [C,C], er [C,C], gap_i, gap_j)`` where entry (a, b) is the
    discrepancy of measuring loop b as ``odo(i_b→i_a) ⊕ L_a ⊕
    odo(j_a→j_b)`` (the PCM consistency kernel, Mangelson et al.)."""
    p_src, p_dst = odo_anchor_poses[src], odo_anchor_poses[dst]
    odo_ii = se2.relative(p_src[:, None, :], p_src[None, :, :])     # [C, C, 3] i_a→i_b
    odo_jj = se2.relative(p_dst[None, :, :], p_dst[:, None, :])     # [C, C, 3] j_b→j_a
    # L_b_pred[a, b] = inv(odo(i_a→i_b)) ⊕ L_a ⊕ odo(j_a→j_b)
    pred = se2.compose(
        se2.compose(se2.inverse(odo_ii), rel[:, None, :]), se2.inverse(odo_jj)
    )
    e = se2.relative(rel[None, :, :], pred)
    et = _norm2(e[..., :2])
    er = torch.abs(se2.normalize_angle(e[..., 2]))
    gap_i = torch.abs(src[:, None] - src[None, :]).to(et.dtype)
    gap_j = torch.abs(dst[:, None] - dst[None, :]).to(et.dtype)
    return et, er, gap_i, gap_j


def pcm_prune(
    loops: VerifiedLoops,
    odo_anchor_poses: Tensor,
    base_t: float = 0.3,
    rate_t: float = 0.25,
    cap_t: float = 2.0,
    base_r: float = 0.15,
    rate_r: float = 0.03,
    cap_r: float = 0.4,
    votes_min: int = 3,
    conflict_k: int = 0,
    conflict_t: float = 3.0,
) -> Tensor:
    """Pairwise-consistent-measurement pruning (PCM, Mangelson et al.)
    with drift-scaled, capped gates and an absolute vote quorum.

    Two loops ``a=(i_a→j_a)``, ``b=(i_b→j_b)`` are checked through the
    odometry cycle ``L_b ≈ odo(i_b→i_a) ⊕ L_a ⊕ odo(j_a→j_b)``; the
    acceptance threshold grows with the square root of the connecting
    odometry path length (random-walk drift model) and is **capped**: an
    uncapped linear model reaches tens of meters at long gaps and makes
    the check vacuous. A loop survives with ``votes_min`` supporters
    (each real revisit produces several mutually consistent loops), so
    isolated gross outliers die while distant true clusters, which can
    never validate each other through drift-sized odometry cycles, keep
    themselves alive. A solitary verified loop still survives
    (``votes ≥ min(n_acc, votes_min)``): the strict verification gates
    and the post-solve residual trim remain the lone-false-positive
    guards.

    ``conflict_k > 0`` adds a local fight: two loops whose endpoints
    nearly coincide (both index gaps ≤ ``conflict_k``) measure the same
    revisit through short, reliable odometry, so a meters-sized cycle
    disagreement (> ``conflict_t``) proves one of them wrong; a loop
    outvoted by its gross local conflicters dies.

    ``odo_anchor_poses`` must be the *raw odometry* anchor chain, not
    the current optimized estimates.
    """
    et, er, gap_i, gap_j = pcm_cycle_errors(
        loops.src, loops.dst, loops.rel, odo_anchor_poses
    )
    g = torch.sqrt(gap_i + gap_j)
    thr_t = torch.clamp(base_t + rate_t * g, max=cap_t)
    thr_r = torch.clamp(base_r + rate_r * g, max=cap_r)

    ok = loops.accept
    both = ok[:, None] & ok[None, :]
    consistent = (et <= thr_t) & (er <= thr_r) & both
    votes = torch.sum(consistent, dim=1)
    n_acc = torch.sum(ok)
    keep = ok & (votes >= torch.clamp(n_acc, max=votes_min))

    if conflict_k > 0:
        local = (gap_i <= conflict_k) & (gap_j <= conflict_k) & both
        support = torch.sum(consistent & local, dim=1)             # includes self
        conflict = torch.sum(local & (et > conflict_t), dim=1)
        keep = keep & (support >= conflict)
    # Nothing accepted → keep stays all-false.
    return keep


def _pick(x: Tensor, lanes: int, which: Tensor) -> Tensor:
    """Row ``which[c]`` of each candidate's ``lanes`` rows: ``x`` is
    ``[C·lanes, ...]``, candidate-major."""
    x = x.reshape(-1, lanes, *x.shape[1:])
    return x[torch.arange(x.shape[0], device=x.device), which]


def _take(res: PointIcpResult, lanes: int, which: Tensor) -> PointIcpResult:
    return PointIcpResult(*(_pick(x, lanes, which) for x in res))


def _rep(x: Tensor, k: int) -> Tensor:
    """Each row of ``x [C, ...]`` ``k`` times in a row: ``[C·k, ...]``."""
    return x[:, None].expand(-1, k, *x.shape[1:]).reshape(-1, *x.shape[1:])


def _verify_batch(
    refw_pts, refw_ok, ref_pts, ref_ok, curw_pts, curw_ok, cur_pts, cur_ok, init,
    *, search_xy, search_theta, n_theta, coarse_res, coarse_points, n_peaks,
    quality_min, err_max, triage_steps_per_nn,
):
    """The per-candidate matching of :func:`verify_pairs_correlative` for
    one batch of ``C`` candidates; the lanes and peaks that the per-pair
    formulation maps over are folded into the batch axis."""
    c = init.shape[0]
    pw, pn = refw_pts.shape[1], cur_pts.shape[1]
    stride = max(pw // coarse_points, 1)
    nstride = max(pn // coarse_points, 1)
    tri_stride = max(pw // 384, 1)
    icp_corr = 4.0 * coarse_res

    # Dual-query coarse search. The WIDE query carries long-gap same-
    # direction revisits (context disambiguates corridor aliases), but on
    # cross- or opposite-heading revisits the two wide clouds share only
    # the crossing region and the wide query's out-of-overlap mass buries
    # the true peak; the overlap-NORMALIZED narrow query restores it. The
    # wide lane keeps raw mean scoring: normalizing it rewards sharp
    # low-overlap alias basins between unrelated places. Both lanes score
    # against the same reference grid.
    grid = build_likelihood_grid_points(
        refw_pts, refw_ok, res=coarse_res, half_extent=12.8, blur_sigma=1.0
    )
    coarse = dict(n_peaks=n_peaks, search_xy=search_xy, search_theta=search_theta,
                  n_theta=n_theta, res=coarse_res, grid=grid)
    peaks_w, scores_w = correlative_top_peaks(
        refw_pts, refw_ok, curw_pts[:, ::stride], curw_ok[:, ::stride], init,
        overlap_norm=False, **coarse)
    peaks_n, scores_n = correlative_top_peaks(
        refw_pts, refw_ok, cur_pts[:, ::nstride], cur_ok[:, ::nstride], init,
        overlap_norm=True, **coarse)

    # Triage each peak list with ITS OWN query (subsampled polish, scored
    # by goodness gated on error): wide-query triage of a narrow-found
    # cross-heading peak re-dilutes exactly what the narrow query
    # recovered, and vice versa.
    rw2_p, rw2_o = refw_pts[:, ::2], refw_ok[:, ::2]
    cwt_p, cwt_o = curw_pts[:, ::tri_stride], curw_ok[:, ::tri_stride]
    triage = dict(iters=12, max_corr=icp_corr, steps_per_nn=triage_steps_per_nn)

    def best_of(q_p, q_o, peaks, scores):
        tri = match_icp_points(
            _rep(rw2_p, n_peaks), _rep(rw2_o, n_peaks), _rep(q_p, n_peaks), _rep(q_o, n_peaks),
            peaks.reshape(c * n_peaks, 3), **triage)
        s = torch.where(~tri.fail & (tri.err < 2.0 * err_max), tri.goodness, -1.0)
        b = torch.argmax(s.reshape(c, n_peaks), dim=1)             # first on ties
        tri = _take(tri, n_peaks, b)
        return (tri.pose, _pick(peaks.reshape(-1, 3), n_peaks, b),
                _pick(scores.reshape(-1), n_peaks, b), tri.goodness, tri.err)

    lanes = [
        best_of(cwt_p, cwt_o, peaks_w, scores_w),
        best_of(cur_pts[:, ::2], cur_ok[:, ::2], peaks_n, scores_n),
    ]
    # Full polish of BOTH winning basins against the wide reference
    # (narrow query, so the accepted pose anchors to the dst submap
    # proper); the gated-better forward result wins the pair.
    fwd2 = match_icp_points(
        _rep(refw_pts, 2), _rep(refw_ok, 2), _rep(cur_pts, 2), _rep(cur_ok, 2),
        torch.stack([lanes[0][0], lanes[1][0]], dim=1).reshape(c * 2, 3),
        iters=30, max_corr=icp_corr)
    f_fail, f_err, f_good = (x.reshape(c, 2) for x in (fwd2.fail, fwd2.err, fwd2.goodness))
    fscore = torch.where(~f_fail & (f_err < err_max), f_good, -1.0)
    # The WIDE lane stays authoritative: whenever its polish alone clears
    # the acceptance-quality bar, take it. The narrow lane exists only to
    # rescue pairs the wide query buries, not to outvote it: letting the
    # lanes compete by goodness re-admits corridor slide-aliases (the
    # narrow query polishes an alias basin marginally sharper than the
    # truth's wide polish).
    wide_pass = ~f_fail[:, 0] & (f_err[:, 0] < err_max) & (f_good[:, 0] >= quality_min)
    # A narrow-lane rescue must also agree with the WIDE context: a true
    # crossing still shares its crossing region between the two wide
    # clouds.
    ctx = match_icp_points(rw2_p, rw2_o, cwt_p, cwt_o, lanes[1][0], **triage)
    ctx_ok = ~ctx.fail & (ctx.goodness >= 0.2) & (ctx.err < 2.0 * err_max)
    narrow_ok = ctx_ok & ~f_fail[:, 1] & (f_err[:, 1] < err_max)
    which = torch.where(wide_pass | ~narrow_ok, 0, torch.argmax(fscore, dim=1))
    fwd = _take(fwd2, 2, which)
    peak, peak_score, tri_good, tri_err = (
        torch.where(which.reshape(c, *([1] * (a.dim() - 1))) == 0, a, b)
        for a, b in zip(lanes[0][1:], lanes[1][1:])
    )
    # Reciprocal: the narrow src submap against the dst side's wide
    # context, from the inverse. A spurious plateau diverges, a real
    # surface alignment inverts exactly. Both legs must be narrow-vs-
    # wide: a narrow-narrow backward leg drifts on exactly the
    # partial-overlap pairs the wide reference was built for.
    bwd = match_icp_points(
        curw_pts, curw_ok, ref_pts, ref_ok, se2.inverse(fwd.pose),
        iters=30, max_corr=icp_corr)
    return fwd, bwd, peak, peak_score, tri_good, tri_err, which


def verify_loops_correlative(
    submaps,
    anchor_poses: Tensor,
    cand: LoopCandidates,
    cand_radius: Tensor | None = None,
    wide_pts: Tensor | None = None,
    wide_ok: Tensor | None = None,
    search_xy: float = 5.0,
    search_theta: float = math.pi,
    n_theta: int = 72,
    coarse_res: float = 0.3,
    coarse_points: int = 192,
    n_peaks: int = 8,
    chunk: int = 32,
    coarse_chunk: int = 16,
    coarse_min_score: float = 0.2,
    quality_min: float = 0.6,
    err_max: float = 0.05,
    cycle_t_max: float = 0.25,
    cycle_r_max: float = 0.1,
    strong_goodness: float = 0.8,
    strong_err: float = 0.03,
    identity_init: bool = False,
) -> VerifiedLoops:
    """Init-free verification of anchor-pair candidates: gathers each
    pair's narrow submap clouds (and, with ``wide_pts``, the wide context
    clouds of both anchors; else the narrow ones stand in) and the
    estimate's relative pose, then runs :func:`verify_pairs_correlative`
    with the options. ``coarse_chunk`` is accepted and not used, as in the
    reference (the coarse search runs in chunks of ``chunk``)."""
    ref_pts, ref_ok = submaps.points[cand.src], submaps.valid[cand.src]
    cur_pts, cur_ok = submaps.points[cand.dst], submaps.valid[cand.dst]
    if wide_pts is not None:
        refw_pts, refw_ok = wide_pts[cand.src], wide_ok[cand.src]
        curw_pts, curw_ok = wide_pts[cand.dst], wide_ok[cand.dst]
    else:
        refw_pts, refw_ok, curw_pts, curw_ok = ref_pts, ref_ok, cur_pts, cur_ok
    odo_rel = se2.relative(anchor_poses[cand.src], anchor_poses[cand.dst])
    return verify_pairs_correlative(
        refw_pts, refw_ok, ref_pts, ref_ok, curw_pts, curw_ok, cur_pts, cur_ok,
        odo_rel, cand.valid, cand_radius, src=cand.src, dst=cand.dst,
        search_xy=search_xy, search_theta=search_theta, n_theta=n_theta,
        coarse_res=coarse_res, coarse_points=coarse_points, n_peaks=n_peaks, chunk=chunk,
        coarse_min_score=coarse_min_score, quality_min=quality_min, err_max=err_max,
        cycle_t_max=cycle_t_max, cycle_r_max=cycle_r_max,
        strong_goodness=strong_goodness, strong_err=strong_err, identity_init=identity_init)


def verify_pairs_correlative(
    refw_pts: Tensor,
    refw_ok: Tensor,
    ref_pts: Tensor,
    ref_ok: Tensor,
    curw_pts: Tensor,
    curw_ok: Tensor,
    cur_pts: Tensor,
    cur_ok: Tensor,
    odo_rel: Tensor,
    valid: Tensor,
    cand_radius: Tensor | None = None,
    src: Tensor | None = None,
    dst: Tensor | None = None,
    search_xy: float = 5.0,
    search_theta: float = math.pi,
    n_theta: int = 72,
    coarse_res: float = 0.3,
    coarse_points: int = 192,
    n_peaks: int = 8,
    chunk: int = 32,
    coarse_min_score: float = 0.2,
    quality_min: float = 0.6,
    err_max: float = 0.05,
    cycle_t_max: float = 0.25,
    cycle_r_max: float = 0.1,
    strong_goodness: float = 0.8,
    strong_err: float = 0.03,
    identity_init: bool = False,
    triage_steps_per_nn: int = 1,
) -> VerifiedLoops:
    """Init-free loop verification of ``C`` candidate pairs whose clouds
    are already gathered: wide ``[C, W, 2]`` and narrow ``[C, P, 2]``
    clouds of the src (``ref``) and dst (``cur``) anchors, the current
    estimate's relative pose ``odo_rel [C, 3]``, ``valid [C]``.

    ICP-only verification needs the odometry guess inside its
    convergence basin, but on a long loop the guess is drift-sized and
    every true revisit fails to verify. Design:

    - the search is exhaustive over ``±search_xy × ±search_theta``,
      centered on **identity** when ``identity_init``: a true revisit
      has a small relative pose by definition even when the estimated
      poses are 20 m apart (Olson-style correlative matching);
    - **both sides are wide** for the coarse score and triage; the
      *final* polish and its gates stay narrow-query-vs-wide-ref so the
      accepted relative pose is anchored to the dst submap proper;
    - the **top ``n_peaks`` NMS peaks** of each lane are polished with
      trimmed point-to-segment ICP and the best gated survivor wins;
      argmax alone hands aliased corridor alignments the match;
    - acceptance is strict (goodness, mean error, reciprocal cycle): the
      pose-graph solve wants few-and-right edges, not many-and-noisy;
    - the correction vs the current estimate must fit ``cand_radius``
      (the uncertainty that proposed the pair).

    ``chunk > 0`` that divides ``C`` bounds live memory: the matching
    runs ``chunk`` candidates at a time.
    """
    c = odo_rel.shape[0]
    dev = odo_rel.device
    if src is None:
        src = torch.zeros(c, dtype=torch.int64, device=dev)
    if dst is None:
        dst = torch.zeros(c, dtype=torch.int64, device=dev)
    init = torch.zeros_like(odo_rel) if identity_init else odo_rel

    clouds = (refw_pts, refw_ok, ref_pts, ref_ok, curw_pts, curw_ok, cur_pts, cur_ok, init)
    opts = dict(search_xy=search_xy, search_theta=search_theta, n_theta=n_theta,
                coarse_res=coarse_res, coarse_points=coarse_points, n_peaks=n_peaks,
                quality_min=quality_min, err_max=err_max,
                triage_steps_per_nn=triage_steps_per_nn)
    if chunk <= 0 or c % chunk != 0 or c == chunk:
        out = _verify_batch(*clouds, **opts)
    else:
        parts = [_verify_batch(*(x[i:i + chunk] for x in clouds), **opts)
                 for i in range(0, c, chunk)]
        out = tuple(
            PointIcpResult(*(torch.cat(f) for f in zip(*xs))) if isinstance(xs[0], PointIcpResult)
            else torch.cat(xs) for xs in zip(*parts))
    fwd, bwd, peak, peak_score, tri_good, tri_err, lane = out

    cycle = se2.compose(fwd.pose, bwd.pose)
    cyc_t = _norm2(cycle[:, :2])
    cyc_r = torch.abs(se2.normalize_angle(cycle[:, 2]))
    reciprocal = (cyc_t < cycle_t_max) & (cyc_r < cycle_r_max)
    d_polish = se2.relative(peak, fwd.pose)
    near_peak = (_norm2(d_polish[:, :2]) < 3.0 * coarse_res) & (
        torch.abs(se2.normalize_angle(d_polish[:, 2])) < 0.2
    )
    delta = se2.relative(odo_rel, fwd.pose)
    if cand_radius is None:
        rad = torch.full((c,), torch.inf, dtype=init.dtype, device=dev)
    else:
        rad = cand_radius
    in_gate = _norm2(delta[:, :2]) <= rad + 0.5

    gates = {
        "coarse_ok": peak_score >= coarse_min_score,
        "fwd_ok": ~fwd.fail,
        "bwd_ok": ~bwd.fail,
        "reciprocal": reciprocal,
        "near_peak": near_peak,
        "in_gate": in_gate,
        "quality_ok": fwd.goodness >= quality_min,
        "err_ok": fwd.err < err_max,
    }
    accept = valid
    for m in gates.values():
        accept = accept & m
    # Narrow-lane rescues NEVER reach the strict tier. On self-similar
    # buildings the narrow query mass-produces drift-confirming aliases
    # that pass every per-pair gate including reciprocity. Their only
    # safe entry is the tentative tier below, whose residual-under-
    # solution promotion is a topological check no single-pair evidence
    # can substitute for.
    accept = accept & (lane == 0)
    # Strong-accept bypass of the reciprocal gate: the backward leg
    # occasionally diverges off a *correct* alignment. A forward match
    # this sharp is beyond what perceptual aliasing produces with wide
    # context, so it stands on its own; PCM and the residual trim remain
    # as backstops. Wide lane only: a narrow slide-alias can polish
    # arbitrarily sharp.
    strong = (
        valid
        & (lane == 0)
        & gates["coarse_ok"]
        & gates["fwd_ok"]
        & gates["near_peak"]
        & gates["in_gate"]
        & (fwd.goodness >= strong_goodness)
        & (fwd.err < strong_err)
    )
    accept = accept | strong

    # Loose tier: matches that *look* correct (sharp coarse peak, tight
    # residual) but miss the strict goodness/reciprocity bar, typical for
    # genuinely low-overlap revisits (opposite-direction passes, long
    # gaps). Loose-tier wrong matches are meters off while correct ones
    # are centimeters, so a residual check against the current solution
    # separates them; they must NOT enter the solve before that promotion.
    tentative = (
        valid
        & ~accept
        & ~fwd.fail
        & near_peak
        & in_gate
        & (peak_score >= 0.6)
        & (fwd.goodness >= 0.35)
        & (fwd.err < 0.04)
        & (cyc_t < 0.3)
        & (cyc_r < 0.1)
    )
    rel = torch.where((accept | tentative)[:, None], torch.nan_to_num(fwd.pose), 0.0)
    gates["coarse_score"] = peak_score
    gates["tri_goodness"] = tri_good      # the winning lane's triage overlap
    gates["tri_err"] = tri_err
    gates["lane"] = lane                  # 0 = wide, 1 = narrow rescue
    gates["goodness"] = fwd.goodness
    gates["err"] = fwd.err
    gates["cycle_t"] = cyc_t
    gates["cycle_r"] = cyc_r
    gates["pose"] = fwd.pose
    return VerifiedLoops(
        src=src, dst=dst, rel=rel, quality=torch.nan_to_num(fwd.goodness), accept=accept,
        tentative=tentative, diag=gates, cov=torch.nan_to_num(fwd.cov),
    )



def _verify_features(model, anchor_scans, anchor_poses, cand, draws) -> VerifiedLoops:
    from ..features import describe_features, detect_features, match_features_at

    feats = detect_features(model, anchor_scans)
    descs = describe_features(model, anchor_scans, feats)
    pair = (type(feats)(*(x[cand.src] for x in feats)), descs[cand.src],
            type(feats)(*(x[cand.dst] for x in feats)), descs[cand.dst])
    res = match_features_at(*pair, *draws(*pair))
    init = se2.relative(anchor_poses[cand.src], anchor_poses[cand.dst])
    delta = se2.relative(init, res.pose)
    small_corr = (_norm2(delta[:, :2]) < 2.0 * MAX_TRANSFORM_DELTA) & (
        torch.abs(se2.normalize_angle(delta[:, 2])) < MAX_ANGLE_DELTA)
    quality = res.n_inliers.to(res.pose.dtype) / float(feats.valid.shape[-1])
    accept = cand.valid & ~res.fail & small_corr & (res.n_inliers >= 8)
    rel = torch.where(accept[:, None], torch.nan_to_num(res.pose), 0.0)
    return VerifiedLoops(src=cand.src, dst=cand.dst, rel=rel, quality=quality, accept=accept)


def verify_loops_features(
    model: LaserModel,
    anchor_scans: Scan,
    anchor_poses: Tensor,
    cand: LoopCandidates,
    generator: torch.Generator,
) -> VerifiedLoops:
    """Feature-RANSAC loop verification, a batched alternative to
    :func:`verify_loops`: interest points and descriptors of every anchor
    once, then each candidate pair RANSAC-matched with hypotheses drawn
    from ``generator``. It needs no initial pose, so it validates loops
    whose estimate drifted beyond ICP's basin; the estimate only bounds
    the correction (twice ``MAX_TRANSFORM_DELTA``). ``quality`` is the
    inlier fraction of the feature budget."""
    from ..features.ransac import candidate_correspondences, draw_hypotheses

    return _verify_features(model, anchor_scans, anchor_poses, cand, lambda *pair: draw_hypotheses(
        candidate_correspondences(*pair)[2], generator))


def verify_loops_features_at(
    model: LaserModel,
    anchor_scans: Scan,
    anchor_poses: Tensor,
    cand: LoopCandidates,
    i1: Tensor,
    i2: Tensor,
) -> VerifiedLoops:
    """:func:`verify_loops_features` with given hypothesis indices ``i1,
    i2 [C, H]`` (its deterministic half)."""
    return _verify_features(model, anchor_scans, anchor_poses, cand, lambda *pair: (i1, i2))
