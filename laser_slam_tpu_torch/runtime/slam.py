"""Offline SLAM over a whole log (port of ``runtime/slam.py``).

``slam_offline`` runs keyframe odometry on the device, reduces the scans
to submaps, then a fixed number of loop-closure waves. Each wave
proposes candidate pairs for all anchors at once (drift-aware pose gate
∪ appearance gate), verifies them in fixed-size chunks (correlative
search + ICP polish, batched over the chunk), banks the verified loops
and runs a robust pose-graph solve over the chain and the bank. The
trajectory is then re-attached to the solved anchors.

With ``use_correlative=False`` the waves are instead ICP-verified rounds
(:func:`_loop_round`) from the current estimate, scan against scan or
(``use_submaps``) submap against submap, at a search radius that doubles
every round.

Anchor spacing is 10 scans per submap; the edge information values are
50 for sequential edges and 10 for loops.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import se2
from ..core.device import resolve_device
from ..core.scan import LaserModel, Scan
from ..graph.loop_closure import (
    VerifiedLoops,
    consistency_prune,
    drift_radius_matrix,
    gate_matrix,
    pcm_cycle_errors,
    pcm_prune,
    select_candidates,
    submap_bboxes,
    verify_loops,
    verify_pairs_correlative,
)
from ..graph.place_recognition import signature_gate, submap_signatures
from ..graph.solve import PoseGraph, optimize, optimize_with_init
from ..graph.submap import Submaps, build_submaps, verify_loops_submap, wide_clouds
from ..graph.submap import submap_bboxes as merged_bboxes
from ..ops.odometry import odometry_keyframe
from ..ops.preprocess import preprocess

Tensor = torch.Tensor

INFO_ADJ = 50.0    # sequential-edge information
INFO_LOOP = 10.0   # loop-edge information
INFO_WEAK = 0.5    # sequential edges spanning a weak/low-overlap step
HINGE_WEIGHT = 1e-3  # seq-weight factor for fractured (unrecoverable)
#                    steps: the edge holds the chain together but must
#                    not resist a loop-driven block rotation


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    anchor_stride: int = 10        # scans per submap
    max_loops: int = 512           # loop-candidate batch capacity
    rounds: int = 6                # propose→verify→solve waves (each
    #                                verifies a fresh candidate slice;
    #                                accepted loops accumulate)
    loop_radius: float = 2.0       # [m] gate radius at zero gap
    gn_iters: int = 20
    use_submaps: bool = False      # (non-correlative branch only)
    submap_points: int = 768       # fixed point budget per submap
    # Correlative loop closing (init-free; the default pipeline).
    use_correlative: bool = True
    drift_rate: float = 0.15       # [m / anchor step] gate-radius growth
    drift_anneal: float = 0.35     # per-round decay of drift_rate
    radius_max: float = 25.0       # [m] clip of the gate radius: must
    #                                admit full-drift revisits; precision
    #                                comes from verification, not gating
    per_dst: int = 12              # candidate budget per later anchor
    search_xy: float = 5.0         # [m] identity-centered verify window
    n_theta: int = 72              # rotation samples over ±π
    coarse_res: float = 0.3        # [m] correlative grid cell; 0.2 finds
    #                                a few percent more true revisits,
    #                                the wide-query coarse search and the
    #                                triage carry the find rate at 0.3
    verify_chunk: int = 32         # candidates per memory chunk
    sig_per_dst: int = 6           # signature-gate candidates per anchor
    radius_max_uncov: float = 60.0 # [m] gate-radius clip for pairs that
    #                                would cover a zero-coverage anchor:
    #                                uncovered spans never benefited from
    #                                earlier solves, so their estimates
    #                                still carry full drift and the
    #                                annealed radius would never reach
    #                                their true revisits
    min_quality: float = 0.6       # ICP goodness floor on loops
    wing: int = 4                  # ± submaps in the wide reference cloud
    wide_points: int = 1536        # point budget of a wide cloud
    n_peaks: int = 8               # polished correlative peaks per pair
    pcm_rate: float = 0.25         # [m/√anchor-step] PCM drift tolerance
    #                                (random-walk model; see pcm_prune)
    pcm_conflict_k: int = 0        # local-conflict window (anchor steps)
    #                                for same-revisit basin fights in
    #                                pcm_prune; 0 disables: on loop-
    #                                starved logs imprecise constraints
    #                                beat none, so the default relies on
    #                                DCS and the residual trim
    trim_residual_t: float = 1.0   # [m] post-solve loop-residual trim
    trim_residual_r: float = 0.3   # [rad]
    promote_residual_t: float = 0.7  # [m] tentative-loop promotion gate
    promote_residual_r: float = 0.2  # [rad]
    promote_anchored_t: float = 3.0  # [m] residual bound for ANCHORED
    #                                tentatives (odometry-cycle-
    #                                consistent with ≥2 strict loops):
    #                                drift-sized, since such loops may
    #                                correct a still-drifted span rather
    #                                than merely confirm a converged one
    promote_anchored_r: float = 0.3  # [rad]
    promote_tentative: bool = True   # unlock loose-tier loops that are
    #                                (a) odometry-cycle-consistent with
    #                                ≥2 active strict loops and (b)
    #                                within a residual bound of the
    #                                solved estimate; residual-only
    #                                promotion admits exactly the drift-
    #                                consistent wrong tentatives
    fast_triage: bool = False      # reuse each ICP correspondence
    #                                search for 2 pose updates in the
    #                                verification triage (the [N, M]
    #                                nearest-neighbour pass is most of
    #                                the per-pair ICP cost); off by
    #                                default because it costs accuracy
    #                                (triage basin flicker on marginal
    #                                pairs)
    cov_rounds: int = 2            # trailing coverage-focused waves:
    #                                the whole candidate budget goes to
    #                                pairs touching zero-coverage anchors
    bank_cap: int = 0              # loop-bank capacity (0 ⇒ max_loops);
    #                                incremental sessions verify far more
    #                                short-gap local pairs, which at
    #                                cap=max_loops evict the long-gap
    #                                global constraints
    weak_seq_weight: float = 1.0   # seq-edge weight factor on "weak"
    #                                (low-overlap deep-fallback) steps:
    #                                the weak flag measures matcher
    #                                difficulty, not odometry error, and
    #                                a softer chain lets aliased loops
    #                                fold it; fractured edges keep the
    #                                true hinge weight
    use_censi_info: bool = True    # per-loop information from the polish
    #                                ICP's Censi covariance (normalized so
    #                                the median loop keeps INFO_LOOP)
    #                                instead of INFO_LOOP × quality


class SlamResult(NamedTuple):
    poses: Tensor         # [T, 3] optimized trajectory
    odo_poses: Tensor     # [T, 3] raw odometry trajectory
    anchor_idx: Tensor    # [A] scan indices of graph vertices
    n_loops: Tensor       # [] loop edges the last solve used
    chi2: Tensor          # [] final graph chi²


def _propose(
    cfg: SlamConfig,
    anchor_poses: Tensor,
    rate: float | Tensor,
    sig_gate: Tensor,
    tried: Tensor,
    coverage: Tensor,
    focus_uncov: bool = False,
    rate0: float | Tensor | None = None,
):
    """Candidate proposal: drift-aware pose gate ∪ appearance gate, minus
    already-tried pairs, coverage-boosted selection. Returns ``(cand,
    trust [C], tried_new)``."""
    a = anchor_poses.shape[0]
    dtype, dev = anchor_poses.dtype, anchor_poses.device
    centers = anchor_poses[:, :2]

    rad = drift_radius_matrix(a, cfg.loop_radius, rate, cfg.radius_max, dtype, dev)
    uncov = coverage == 0
    pair_uncov = uncov[:, None] | uncov[None, :]
    if rate0 is None:
        rate0 = cfg.drift_rate
    rad0 = drift_radius_matrix(a, cfg.loop_radius, rate0, cfg.radius_max_uncov, dtype, dev)
    rad = torch.where(pair_uncov, torch.maximum(rad, rad0), rad)
    pose_gate = gate_matrix(centers, radius=rad, min_gap=5, overlap_min=None)
    gate = (pose_gate | sig_gate) & ~tried
    # Coverage-focused waves spend the WHOLE candidate budget on pairs
    # that would bind an uncovered anchor: in the mixed waves these pairs
    # compete with thousands of easy re-verifications around well-covered
    # revisits and lose.
    if focus_uncov:
        gate = gate & pair_uncov
    boost = 0.5 * pair_uncov.to(dtype)
    cand = select_candidates(
        gate, centers, cfg.max_loops, radius=rad, per_dst=cfg.per_dst, boost=boost
    )
    gap = torch.abs(cand.dst - cand.src).to(dtype)
    cand_uncov = uncov[cand.src] | uncov[cand.dst]
    trust = cfg.loop_radius + torch.where(cand_uncov, rate0, rate) * gap
    # The selected flat indices are distinct, so no pair is written twice.
    tried_new = tried.clone()
    tried_new[cand.src, cand.dst] = tried[cand.src, cand.dst] | cand.valid
    return cand, trust, tried_new


def _verify_chunk(
    cfg: SlamConfig,
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
    trust: Tensor,
) -> VerifiedLoops:
    """Verify one fixed-size chunk of candidates with pre-gathered
    clouds: the shapes depend only on the chunk size and the narrow/wide
    point budgets, not on the anchor count or the laser's beam count."""
    return verify_pairs_correlative(
        refw_pts, refw_ok, ref_pts, ref_ok,
        curw_pts, curw_ok, cur_pts, cur_ok,
        odo_rel, valid, cand_radius=trust,
        search_xy=cfg.search_xy,
        search_theta=math.pi,
        n_theta=cfg.n_theta,
        coarse_res=cfg.coarse_res,
        n_peaks=cfg.n_peaks,
        chunk=0,
        quality_min=cfg.min_quality,
        identity_init=True,
        triage_steps_per_nn=2 if cfg.fast_triage else 1,
    )


def _norm2(v: Tensor) -> Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _nanmedian_active(x: Tensor, active: Tensor) -> Tensor:
    """Median of ``x[active]`` that averages the two middle values of an
    even count (``torch.nanmedian`` returns the lower one); NaN when
    nothing is active."""
    srt = torch.sort(torch.where(active, x, torch.inf)).values
    n = torch.sum(active)
    mid = srt[torch.stack([torch.clamp((n - 1) // 2, min=0), n // 2])]
    return torch.where(n > 0, 0.5 * (mid[0] + mid[1]), torch.nan)


def _solve_with_bank(
    cfg: SlamConfig,
    anchor_poses: Tensor,
    odo_anchor_poses: Tensor,
    rel_seq: Tensor,
    seq_weight: Tensor,
    bank_src: Tensor,
    bank_dst: Tensor,
    bank_rel: Tensor,
    bank_quality: Tensor,
    bank_active: Tensor,
    bank_strict: Tensor,
    bank_cov: Tensor | None = None,
):
    """Robust solve over the sequential chain + the accumulated loop
    bank: PCM pruning (drift-scaled mutual consistency through the raw
    odometry), LAGO linear initialization, LM with Huber/DCS kernels,
    then one residual-trim + tentative-promotion + re-solve pass.
    Returns ``(anchor poses, n used, chi², used [bank] bool)``.

    Two complementary residual mechanisms act around the solves:

    - **trim** removes strict loops whose measurement disagrees with the
      first solution: with most strict loops correct the first solution
      is mostly right, so a grossly false loop (perceptual alias) shows
      a huge residual and is deactivated. PCM alone cannot make this
      separation (an aliased cluster stays self-consistent under
      drift-scaled thresholds), and DCS only downweights.
    - **promotion** adds loose-tier loops whose residual under the
      current estimate is small, and only those that are ALSO odometry-
      cycle-consistent (PCM kernel) with at least two active strict
      loops: topological support that does not depend on the current
      estimate. The residual-only gate promotes exactly the drift-
      consistent wrong tentatives in still-drifted regions."""
    a = anchor_poses.shape[0]
    dtype, dev = anchor_poses.dtype, anchor_poses.device
    nb = bank_src.shape[0]
    bank = VerifiedLoops(
        src=bank_src, dst=bank_dst, rel=bank_rel, quality=bank_quality, accept=bank_active,
    )
    keep = pcm_prune(bank, odo_anchor_poses, rate_t=cfg.pcm_rate,
                     conflict_k=cfg.pcm_conflict_k)

    et_b, er_b, gi_b, gj_b = pcm_cycle_errors(bank_src, bank_dst, bank_rel, odo_anchor_poses)
    g_b = torch.sqrt(gi_b + gj_b)
    thr_tb = torch.clamp(0.3 + cfg.pcm_rate * g_b, max=2.0)
    thr_rb = torch.clamp(0.15 + 0.03 * g_b, max=0.4)
    cons_b = (et_b <= thr_tb) & (er_b <= thr_rb)
    strict_on = bank_active & bank_strict
    anchored = torch.sum(cons_b & strict_on[None, :], dim=1) >= 2

    def residuals(poses):
        pred = se2.relative(poses[bank_src], poses[bank_dst])
        d = se2.relative(bank_rel, pred)
        return _norm2(d[:, :2]), torch.abs(se2.normalize_angle(d[:, 2]))

    def promoted(poses):
        dt, dr = residuals(poses)
        near = (dt < cfg.promote_residual_t) & (dr < cfg.promote_residual_r)
        # Anchored tentatives may CORRECT the estimate (their residual is
        # the local drift, not an error signal), so their bound is
        # drift-sized rather than convergence-sized.
        near_anchored = (dt < cfg.promote_anchored_t) & (dr < cfg.promote_anchored_r)
        return bank_active & ~bank_strict & anchored & (near | near_anchored)

    # Strict loops only for the first solve: promotion under a still-
    # drifted estimate admits exactly the drift-consistent (wrong)
    # tentatives and anchors the drift.
    keep = keep & bank_strict

    seq_i = torch.arange(a - 1, device=dev)
    eye = torch.eye(3, dtype=dtype, device=dev)
    i_all = torch.cat([seq_i, bank_src.to(torch.int64)])
    j_all = torch.cat([seq_i + 1, bank_dst.to(torch.int64)])
    meas = torch.cat([rel_seq, bank_rel], dim=0)
    if cfg.use_censi_info and bank_cov is not None:
        # Per-loop information from the matcher covariance, normalized so
        # the *median* active loop carries INFO_LOOP: raw Censi
        # information (~1e5 for a 500-point match at 2 cm residual) would
        # let DCS annihilate every drift-sized residual before the solve
        # can close it, so only the relative weighting is kept.
        w = torch.linalg.inv_ex(bank_cov + 1e-6 * eye)[0]
        tr = 0.5 * (w[:, 0, 0] + w[:, 1, 1])
        med = _nanmedian_active(tr, bank_active)
        # max(NaN, ·) stays NaN, as for an empty bank in the reference.
        scale = INFO_LOOP / torch.where(med < 1e-6, 1e-6, med)
        loop_info = torch.clamp(w * scale, 0.0, 10.0 * INFO_LOOP)
        loop_info = 0.5 * (loop_info + loop_info.transpose(-1, -2))
    else:
        loop_info = (eye * INFO_LOOP)[None] * torch.clamp(bank_quality, 0.0, 1.0)[:, None, None]
    info = torch.cat(
        [(eye * INFO_ADJ)[None] * seq_weight[:, None, None], loop_info], dim=0
    )
    ones = torch.ones(a - 1, dtype=torch.bool, device=dev)
    kernel = torch.cat([torch.zeros(a - 1, dtype=torch.int64, device=dev),
                        torch.ones(nb, dtype=torch.int64, device=dev)])
    g = PoseGraph(
        poses=anchor_poses,
        v_active=torch.ones(a, dtype=torch.bool, device=dev),
        i=i_all, j=j_all, meas=meas, info=info,
        e_active=torch.cat([ones, keep]),
        kernel=kernel,
    )
    g_opt, _ = optimize_with_init(g, cfg.gn_iters)

    # Residual trim + promotion under the first solution, then re-solve.
    dt, dr = residuals(g_opt.poses)
    bad = (dt > cfg.trim_residual_t) | (dr > cfg.trim_residual_r)
    promo = promoted(g_opt.poses) if cfg.promote_tentative else torch.zeros_like(bank_strict)
    keep2 = ((keep & bank_strict) | promo) & ~bad
    g_opt2, chi2_ = optimize(g_opt._replace(e_active=torch.cat([ones, keep2])), cfg.gn_iters)
    # keep2 is the loop set the final solve actually used (post PCM, post
    # residual trim, promotions included): diagnostics audit the SOLVED
    # constraint set rather than the raw bank.
    return g_opt2.poses, torch.sum(keep2), chi2_, keep2


def _bank_tensors(bank: dict, device) -> tuple:
    """The loop bank's arrays as tensors on ``device``, in the order
    :func:`_solve_with_bank` takes them."""
    def t(key, dtype=None):
        return torch.as_tensor(bank[key], dtype=dtype, device=device)
    return (t("src", torch.int64), t("dst", torch.int64), t("rel"), t("q"),
            t("act"), t("strict"), t("cov"))


def run_correlative_rounds(
    cfg: SlamConfig,
    submaps: Submaps,
    anchor_poses: Tensor,
    rel_seq: Tensor,
    seq_weight: Tensor,
    bank: dict | None = None,
    tried: Tensor | None = None,
    odo_anchor_poses: Tensor | None = None,
    block_id: Tensor | None = None,
    timing: dict | None = None,
):
    """The init-free loop-closure backend: ``cfg.rounds + cfg.cov_rounds``
    waves of propose→verify→bank→robust-solve over prebuilt submaps.

    Factored out of :func:`slam_offline` so incremental callers drive the
    *same* machinery: pass ``bank``/``tried`` from a previous call to
    continue a session. The loop bank is a dict of numpy arrays on the
    host (``src``, ``dst``, ``rel``, ``q``, ``act``, ``strict``, ``cov``,
    and after a solve ``used``); the bookkeeping between the device
    stages (adaptive drift rate, coverage, adaptive hinges, bank order)
    is numpy.

    With a ``timing`` dict, every stage is synchronised and its seconds
    are recorded: ``signature_gate``, ``wide_clouds`` and, per wave, the
    lists ``bookkeeping`` (host), ``propose``, ``verify`` and ``solve``.

    Returns ``(anchor_poses, n_loops, chi, bank, tried)``.
    """
    dtype, dev = anchor_poses.dtype, anchor_poses.device

    def lap(key, t0, append=False):
        if timing is None:
            return t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        now = time.perf_counter()
        if append:
            timing.setdefault(key, []).append(now - t0)
        else:
            timing[key] = now - t0
        return now

    t0 = time.perf_counter()
    sig_gate = signature_gate(
        submap_signatures(submaps.points, submaps.valid), min_gap=5, per_dst=cfg.sig_per_dst
    )
    t0 = lap("signature_gate", t0)
    if odo_anchor_poses is None:
        # First call of a session: the incoming estimate IS the raw
        # odometry chain (the PCM/drift reference).
        odo_anchor_poses = anchor_poses
    a = int(anchor_poses.shape[0])
    if block_id is None:
        block_id = torch.zeros(a, dtype=torch.int64, device=dev)
    wide_pts, wide_ok = wide_clouds(
        submaps, odo_anchor_poses, wing=cfg.wing, max_points=cfg.wide_points, block_id=block_id
    )
    t0 = lap("wide_clouds", t0)

    def verify(ap, rate, tr, cov, focus, r0):
        tp = time.perf_counter()
        cand, trust, tr_new = _propose(cfg, ap, rate, sig_gate, tr, cov, focus, r0)
        tp = lap("propose", tp, append=True)
        # Each chunk's clouds are gathered here, so the verifier's shapes
        # do not depend on the anchor count.
        rel_all = se2.relative(ap[cand.src], ap[cand.dst])
        c = cfg.verify_chunk
        outs = []
        for i in range(0, int(cand.src.shape[0]), c):
            s_, d_ = cand.src[i:i + c], cand.dst[i:i + c]
            outs.append(_verify_chunk(
                cfg,
                wide_pts[s_], wide_ok[s_], submaps.points[s_], submaps.valid[s_],
                wide_pts[d_], wide_ok[d_], submaps.points[d_], submaps.valid[d_],
                rel_all[i:i + c], cand.valid[i:i + c], trust[i:i + c],
            ))
        # One fetch of every chunk's outputs, after all chunks are queued.
        loops = {
            k: torch.cat([getattr(o, k) for o in outs]).cpu().numpy()
            for k in ("rel", "quality", "accept", "tentative", "cov")
        }
        loops["src"], loops["dst"] = cand.src.cpu().numpy(), cand.dst.cpu().numpy()
        lap("verify", tp, append=True)
        return loops, tr_new

    if tried is None:
        tried = torch.zeros(a, a, dtype=torch.bool, device=dev)
    cap = cfg.bank_cap or cfg.max_loops
    if bank is None:
        bank = {
            "src": np.zeros(cap, np.int32),
            "dst": np.zeros(cap, np.int32),
            "rel": np.zeros((cap, 3), np.float32),
            "q": np.zeros(cap, np.float32),
            "act": np.zeros(cap, bool),
            "strict": np.zeros(cap, bool),
            "cov": np.tile(np.eye(3, dtype=np.float32), (cap, 1, 1)),
        }
    n_loops = torch.zeros((), dtype=torch.int64, device=dev)
    chi = torch.zeros((), dtype=dtype, device=dev)
    # Adaptive drift rate: cfg.drift_rate is the prior; once the bank
    # holds enough strict loops, the p90 of their |correction| / gap
    # re-estimates the log's ACTUAL drift. A log that drifts far less
    # than the prior would otherwise get trust radii wide enough to admit
    # perceptually-aliased corridor matches.
    rate_hat = float(cfg.drift_rate)
    rate_hat_uncov = float(cfg.drift_rate)
    odo_np = odo_anchor_poses.cpu().numpy()
    bid_np = block_id.cpu().numpy()
    sw0_np = seq_weight.cpu().numpy()
    for r in range(cfg.rounds + cfg.cov_rounds):
        t0 = time.perf_counter()
        focus = r >= cfg.rounds
        on_r = bank["act"] & bank["strict"]
        if on_r.sum() >= 20:
            orel = se2.np_relative(odo_np[bank["src"][on_r]], odo_np[bank["dst"][on_r]])
            dd = se2.np_relative(orel, bank["rel"][on_r])
            gaps = np.maximum(
                np.abs(bank["dst"][on_r].astype(np.int64)
                       - bank["src"][on_r].astype(np.int64)), 1
            )
            per_gap = np.linalg.norm(dd[:, :2], axis=-1) / gaps
            rate_hat = float(
                np.clip(1.5 * np.percentile(per_gap, 90), 0.02, cfg.drift_rate)
            )
            # The UNCOVERED-pair escalation rate must come from loops that
            # actually spanned long gaps: incremental sessions fill the
            # bank with short local loops first, whose tiny per-gap
            # corrections collapse rate_hat and shrink the trust radius
            # BELOW real long-gap drift; the true global revisits then
            # fail verification once and are blacklisted in `tried`.
            long_g = gaps >= 50
            if long_g.sum() >= 10:
                rate_hat_uncov = float(
                    np.clip(1.5 * np.percentile(per_gap[long_g], 90), 0.02, cfg.drift_rate)
                )
            else:
                rate_hat_uncov = float(cfg.drift_rate)
        # The drift rate anneals: once a solve has absorbed the loops
        # found so far, pose distances are trustworthy at tighter radii
        # and the budget shifts to nearby pairs. Already-verified pairs
        # are excluded, so every round spends its full budget on a new
        # slice of the candidate space.
        rate = float(np.float32(rate_hat * (cfg.drift_anneal ** min(r, cfg.rounds - 1))))
        # Coverage = loops that bind an anchor to a DISTANT part of the
        # trajectory (long index gap or another fracture block) AND are
        # consistent with the current solution. Short intra-block loops
        # polish local geometry but cannot place a drifted block
        # globally, and a *wrong* loop on a still-misplaced anchor must
        # not mark it covered.
        ap_np = anchor_poses.cpu().numpy()
        on = bank["act"] & bank["strict"]
        gapb = np.abs(bank["dst"].astype(np.int64) - bank["src"].astype(np.int64))
        pred = se2.np_relative(ap_np[bank["src"]], ap_np[bank["dst"]])
        resid = se2.np_relative(bank["rel"], pred)
        consistent = (np.linalg.norm(resid[:, :2], axis=-1) < 1.0) & (
            np.abs((resid[:, 2] + np.pi) % (2 * np.pi) - np.pi) < 0.3
        )
        binds = on & consistent & (
            (gapb >= 20) | (bid_np[bank["src"]] != bid_np[bank["dst"]])
        )
        cov = np.zeros(a, np.int32)
        np.add.at(cov, bank["src"][binds], 1)
        np.add.at(cov, bank["dst"][binds], 1)
        # Adaptive hinges: a fractured edge is freed (HINGE_WEIGHT) only
        # while the blocks on BOTH sides carry binding loops; a block
        # with no loops would swing on a free hinge like a pendulum.
        # Until loops arrive, the fracture keeps corridor-grade weight:
        # drifted odometry beats no constraint at all.
        sw_np = sw0_np.copy()
        # Exact-zero weights are inactive padding edges of incremental
        # callers, not hinges.
        frac_e = (sw_np > 0) & (sw_np < 2.0 * HINGE_WEIGHT)
        if frac_e.any():
            n_blocks = int(bid_np.max()) + 1
            block_cov = np.zeros(n_blocks, np.int64)
            np.add.at(block_cov, bid_np, cov.astype(np.int64))
            lo_ok = block_cov[bid_np[np.arange(a - 1)]] >= 2
            hi_ok = block_cov[bid_np[np.arange(1, a)]] >= 2
            sw_np[frac_e & ~(lo_ok & hi_ok)] = INFO_WEAK / INFO_ADJ
        seq_weight_round = torch.as_tensor(sw_np, dtype=dtype, device=dev)
        lap("bookkeeping", t0, append=True)
        loops, tried = verify(
            anchor_poses, rate, tried, torch.as_tensor(cov, device=dev), focus,
            float(np.float32(rate_hat_uncov)),
        )
        t0 = time.perf_counter()
        acc = loops["accept"]
        # Bank both tiers: strict accepts enter the solve directly;
        # tentative matches wait in the bank until the promotion check in
        # _solve_with_bank unlocks them.
        take = acc | loops["tentative"]
        act = bank["act"]
        src = np.concatenate([bank["src"][act], loops["src"][take]])
        dst = np.concatenate([bank["dst"][act], loops["dst"][take]])
        rel = np.concatenate([bank["rel"][act], loops["rel"][take]])
        q = np.concatenate([bank["q"][act], loops["quality"][take]])
        strict = np.concatenate([bank["strict"][act], acc[take]])
        covs = np.concatenate([bank["cov"][act], loops["cov"][take]])
        # Strict loops outrank tentative ones when the cap binds.
        order = np.argsort(-(q + 10.0 * strict))[:cap]
        n = len(order)
        for key, val in (("src", src), ("dst", dst), ("rel", rel),
                         ("q", q), ("strict", strict), ("cov", covs)):
            bank[key][:n] = val[order]
        bank["act"][:] = False
        bank["act"][:n] = True
        anchor_poses, n_loops, chi, used = _solve_with_bank(
            cfg, anchor_poses, odo_anchor_poses, rel_seq, seq_weight_round,
            *_bank_tensors(bank, dev),
        )
        bank["used"] = used.cpu().numpy()
        lap("solve", t0, append=True)
    return anchor_poses, n_loops, chi, bank, tried


def _loop_round(
    model: LaserModel,
    cfg: SlamConfig,
    anchor_scans: Scan,
    anchor_poses: Tensor,
    rel_seq: Tensor,
    radius: float | None = None,
    seq_weight: Tensor | None = None,
    submaps: Submaps | None = None,
):
    """One gate → verify → prune → solve round over the anchors; returns
    ``(anchor poses, number of loops kept, chi²)``. ``radius`` is the
    search radius and the verifier's starting correspondence gate
    (default ``cfg.loop_radius``); ``seq_weight [A-1]`` scales the
    sequential edges' information. With ``submaps``, gating and
    verification run on the merged keyframe-group clouds instead of
    single anchor scans."""
    if radius is None:
        radius = cfg.loop_radius
    if submaps is not None:
        bbox_lo, bbox_hi = merged_bboxes(submaps, anchor_poses)
    else:
        bbox_lo, bbox_hi = submap_bboxes(model, anchor_scans, anchor_poses)
    gate = gate_matrix(anchor_poses[:, :2], bbox_lo, bbox_hi, radius=radius)
    cand = select_candidates(gate, anchor_poses[:, :2], cfg.max_loops)
    if submaps is not None:
        loops = verify_loops_submap(submaps, anchor_poses, cand, max_corr=radius)
    else:
        loops = verify_loops(model, anchor_scans, anchor_poses, cand, max_corr=radius)
    keep = consistency_prune(loops, anchor_poses)

    a, c = anchor_poses.shape[0], cand.src.shape[0]
    dtype, dev = anchor_poses.dtype, anchor_poses.device
    seq_i = torch.arange(a - 1, device=dev)
    if seq_weight is None:
        seq_weight = torch.ones(a - 1, dtype=dtype, device=dev)
    eye = torch.eye(3, dtype=dtype, device=dev)
    g = PoseGraph(
        poses=anchor_poses,
        v_active=torch.ones(a, dtype=torch.bool, device=dev),
        i=torch.cat([seq_i, loops.src]),
        j=torch.cat([seq_i + 1, loops.dst]),
        meas=torch.cat([rel_seq, loops.rel]),
        info=torch.cat([eye * INFO_ADJ * seq_weight[:, None, None],
                        eye * INFO_LOOP * loops.quality[:, None, None]]),
        e_active=torch.cat([torch.ones(a - 1, dtype=torch.bool, device=dev), keep]),
        kernel=torch.cat([torch.zeros(a - 1, dtype=torch.int64, device=dev),     # seq: Huber
                          torch.ones(c, dtype=torch.int64, device=dev)]),        # loops: DCS
    )
    g_opt, chi = optimize(g, cfg.gn_iters)
    return g_opt.poses, torch.sum(keep), chi


def run_icp_rounds(
    model: LaserModel,
    cfg: SlamConfig,
    anchor_scans: Scan,
    anchor_poses: Tensor,
    rel_seq: Tensor,
    seq_weight: Tensor,
    submaps: Submaps | None = None,
    timing: dict | None = None,
):
    """``cfg.rounds`` ICP-verified rounds (:func:`_loop_round`) at an
    escalating search radius, ``cfg.loop_radius · 2^r``: early rounds
    close tight, reliable loops; later ones, with the drift already
    reduced, reach farther. Returns ``(anchor poses, loops kept in the
    last round, chi²)``; with a ``timing`` dict, each round's seconds are
    appended to ``timing["rounds"]``."""
    dev = anchor_poses.device
    n_loops = torch.zeros((), dtype=torch.int64, device=dev)
    chi = torch.zeros((), dtype=anchor_poses.dtype, device=dev)
    for r in range(cfg.rounds):
        t0 = time.perf_counter()
        radius = float(np.float32(cfg.loop_radius * (2.0 ** r)))     # a float32 value
        anchor_poses, n_loops, chi = _loop_round(
            model, cfg, anchor_scans, anchor_poses, rel_seq, radius, seq_weight, submaps)
        if timing is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timing.setdefault("rounds", []).append(time.perf_counter() - t0)
    return anchor_poses, n_loops, chi


def slam_offline(
    model: LaserModel,
    ranges,
    cfg: SlamConfig = SlamConfig(),
    diag: dict | None = None,
    timestamps=None,
    device: torch.device | str | None = None,
) -> SlamResult:
    """End-to-end SLAM over a ``[T, N]`` range log (array or tensor).

    Runs on ``device``: ``cuda`` unless the caller names another, and
    then it raises where there is no CUDA device; ``device="cpu"`` asks
    for the CPU. With a ``diag`` dict, the seconds of every stage
    (``diag["timing"]``) are left in it and, on the correlative branch,
    the loop bank, the anchor poses before and after, the tried matrix
    and the sequential weights.
    """
    dev = resolve_device(device)
    timing = diag.setdefault("timing", {}) if diag is not None else None
    ranges = torch.as_tensor(ranges, dtype=torch.float32).to(dev)

    def lap(key, t0):
        if timing is None:
            return t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timing[key] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    (scans, odo_poses, anchor_idx, anchor_scans, anchor_poses, rel_seq,
     seq_weight, block_id) = _frontend(model, cfg, ranges, timestamps)
    t0 = lap("frontend", t0)
    submaps = None
    if cfg.use_submaps or cfg.use_correlative:
        submaps = build_submaps(model, scans, odo_poses, cfg.anchor_stride, cfg.submap_points)
        t0 = lap("submaps", t0)

    odo_anchor_poses = anchor_poses
    if cfg.use_correlative:
        anchor_poses, n_loops, chi, bank, tried = run_correlative_rounds(
            cfg, submaps, anchor_poses, rel_seq, seq_weight,
            odo_anchor_poses=odo_anchor_poses, block_id=block_id, timing=timing,
        )
    else:
        anchor_poses, n_loops, chi = run_icp_rounds(
            model, cfg, anchor_scans, anchor_poses, rel_seq, seq_weight, submaps, timing=timing)
    t0 = time.perf_counter()
    final = _reattach(cfg, anchor_poses, odo_poses)
    lap("reattach", t0)

    if diag is not None and cfg.use_correlative:
        diag["bank"] = {k: np.array(v) for k, v in bank.items()}
        diag["anchor_poses"] = anchor_poses.cpu().numpy()
        diag["odo_anchor_poses"] = odo_anchor_poses.cpu().numpy()
        diag["tried"] = tried.cpu().numpy()
        diag["seq_weight"] = seq_weight.cpu().numpy()

    return SlamResult(
        poses=final, odo_poses=odo_poses, anchor_idx=anchor_idx, n_loops=n_loops, chi2=chi,
    )


def _frontend(model: LaserModel, cfg: SlamConfig, ranges: Tensor, timestamps=None):
    """Preprocess + two-pass keyframe odometry + anchor/edge derivation,
    on the device of ``ranges``."""
    scans = preprocess(ranges, model)
    odo = odometry_keyframe(model, scans, timestamps=timestamps)
    return (scans,) + _frontend_post(cfg, scans, odo.poses, odo.weak, odo.fracture)


def _frontend_post(cfg: SlamConfig, scans: Scan, poses: Tensor, weak: Tensor, fracture: Tensor):
    dev = poses.device
    t = scans.ranges.shape[0]
    anchor_idx = torch.arange(0, t - (t % cfg.anchor_stride), cfg.anchor_stride, device=dev)
    anchor_scans = Scan(*(x[anchor_idx] for x in scans))
    anchor_poses = poses[anchor_idx]
    rel_seq = se2.relative(anchor_poses[:-1], anchor_poses[1:])
    k = anchor_idx.shape[0]
    # Step t (the match scan t-1 → t) is covered by anchor edge
    # floor((t-1)/stride); sum the flags per edge.
    edge_of_step = torch.clamp(
        torch.div(torch.arange(t, device=dev) - 1, cfg.anchor_stride, rounding_mode="floor"),
        0, k - 2,
    )

    def per_edge(flags):
        return torch.zeros(k - 1, dtype=torch.int64, device=dev).index_add_(
            0, edge_of_step, flags.to(torch.int64))

    weak_per_edge = per_edge(weak)
    # Fractured steps (unrecoverable matches) make the spanning anchor
    # edge a near-free hinge: its measured relative rotation can be wrong
    # by more than 90°, and any non-negligible information there fights
    # the loop closures that are the only way to place the blocks on
    # either side.
    frac_per_edge = per_edge(fracture)
    # Weak (low-overlap) steps keep near-full weight by default (see
    # SlamConfig.weak_seq_weight). Only true fractures hinge.
    one = torch.ones(k - 1, dtype=poses.dtype, device=dev)
    seq_weight = torch.where(
        frac_per_edge > 0,
        HINGE_WEIGHT * one,
        torch.where(weak_per_edge > 0, cfg.weak_seq_weight * one, one),
    )
    # Block id per anchor: increments at each fractured edge; map context
    # (wide clouds) must never merge across blocks.
    block_id = torch.cat(
        [torch.zeros(1, dtype=torch.int64, device=dev),
         torch.cumsum((frac_per_edge > 0).to(torch.int64), dim=0)]
    )
    return (poses, anchor_idx, anchor_scans, anchor_poses, rel_seq, seq_weight, block_id)


def _reattach(cfg: SlamConfig, anchor_poses: Tensor, odo_poses: Tensor) -> Tensor:
    """Every scan's pose from its anchor's solved pose and the odometry
    relative between the two."""
    t = odo_poses.shape[0]
    seg = torch.arange(t, device=odo_poses.device) // cfg.anchor_stride
    seg = torch.clamp(seg, 0, anchor_poses.shape[0] - 1)
    rel_to_anchor = se2.relative(odo_poses[seg * cfg.anchor_stride], odo_poses)
    return se2.compose(anchor_poses[seg], rel_to_anchor)
