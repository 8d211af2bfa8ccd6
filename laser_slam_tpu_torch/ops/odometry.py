"""Scan-matching odometry over a whole log (port of ``ops/odometry.py``).

- :func:`odometry_keyframe` — keyframe odometry in two passes: a
  sequential chain of PSM matches with keyframe switching that only
  *flags* steps whose banded matchers failed (on a CUDA device the whole
  chain is one kernel launch), then a batched ±π correlative re-match
  of the flagged steps and a re-chaining.
- :func:`odometry_pairwise` — all consecutive pairs matched in one
  batch (PSM, or polar ICP with ``use_icp``), then a log-depth pose
  chain.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import se2
from ..core.scan import LaserModel, Scan
from ..utils.profiling import profiler, trace
from .correlative import match_correlative
from .cuda.psm_kernel import match_psm_fused, odometry_chain_fused
from .icp import match_icp
from .psm import error_index

Tensor = torch.Tensor

# Keyframe switch threshold on sqrt(err_x + err_y), meters
# (runlogImproved's 5 cm gate).
KEYFRAME_ERR_THRESH = 0.05


class OdometryResult(NamedTuple):
    poses: Tensor       # [T, 3] global poses (pose[0] = origin)
    switched: Tensor    # [T] bool — keyframe switched at this step
    discarded: Tensor   # [T] bool — frame dropped (all matchers failed)
    weak: Tensor        # [T] bool — step estimate is low-confidence
    fracture: Tensor | None = None   # [T] bool — unrecoverable step; the
    # chain is broken there (a free hinge for downstream consumers)
    rematched: Tensor | None = None  # [T] bool — re-matched by pass 2


class _OdoCarry(NamedTuple):
    ref: Scan           # current keyframe scan [N]
    last: Scan          # previous scan [N]
    ref_gpose: Tensor   # [3] global pose of keyframe
    last_gpose: Tensor  # [3] global pose of previous scan
    prior_rel: Tensor   # [3] pose of previous scan in keyframe frame


def _stack2(a: Scan, b: Scan) -> Scan:
    return Scan(*(torch.stack([x, y]) for x, y in zip(a, b)))


def _where_scan(cond: Tensor, a: Scan, b: Scan) -> Scan:
    return Scan(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _match_and_score(model: LaserModel, ref: Scan, cur: Scan, init: Tensor, last: Scan):
    """PSM match of ``cur`` against ``ref`` and its error index against
    ``last``: one fused launch on a CUDA device. On the CPU the matcher
    is called with its plain signature, so that a stand-in can take its
    place in this module, and the error index is the plain one."""
    if cur.ranges.device.type == "cuda":
        return match_psm_fused(model, ref, cur, init, error_ref=last)
    res = match_psm_fused(model, ref, cur, init)
    return res, error_index(model, last, cur, res.pose)


def _settle(carry: _OdoCarry, cur: Scan, need_switch: Tensor, rel: Tensor, all_failed: Tensor):
    """Settles a step from its chosen relative pose ``rel`` (against the
    keyframe, or against the previous scan when the keyframe switched):
    the new carry, the scan's global pose and the ``switched`` and
    ``discarded`` flags. A discarded frame leaves the carry as it was."""
    discarded = need_switch & all_failed
    keep = ~discarded
    base = torch.where(need_switch, carry.last_gpose, carry.ref_gpose)
    gpose = se2.compose(base, rel)
    new_carry = _OdoCarry(
        ref=_where_scan(need_switch & keep, carry.last, carry.ref),
        last=_where_scan(keep, cur, carry.last),
        ref_gpose=torch.where(keep, base, carry.ref_gpose),
        last_gpose=torch.where(keep, gpose, carry.last_gpose),
        prior_rel=torch.where(keep, rel, carry.prior_rel),
    )
    out_pose = torch.where(keep, gpose, carry.last_gpose)
    return new_carry, out_pose, need_switch & keep, discarded


def _step_flagged(model: LaserModel, carry: _OdoCarry, cur: Scan):
    """One odometry step with no host sync, the exhaustive fallback left
    to the caller.

    The keyframe match ``(ref, cur, prior_rel)`` and the switch-branch
    match ``(last, cur, 0)`` run as one fused PSM launch of two pairs,
    both error indices (against ``last``) with them; the branch is a
    select (both branches are pure, so the result equals a conditional).

    Returns ``(new_carry, (pose, switched, discarded, deep), psm_rel)``.
    ``deep`` says that the keyframe switched and the re-match against the
    previous scan is bad too, so the step needs the ±π correlative match:
    in a batch afterwards (:func:`odometry_keyframe`, pass 2), or at once
    (:func:`_step_deep`, from the carry *before* this step and ``psm_rel``,
    the banded estimate against the previous scan)."""
    cur2 = _stack2(cur, cur)
    res, (ex, ey, _) = _match_and_score(
        model,
        _stack2(carry.ref, carry.last),
        cur2,
        torch.stack([carry.prior_rel, torch.zeros_like(carry.prior_rel)]),
        _stack2(carry.last, carry.last),
    )
    err = torch.sqrt(ex + ey)
    need_switch = res.fail[0] | (err[0] > KEYFRAME_ERR_THRESH)
    # Switched: re-match against the previous scan from a zero prior and
    # flag it for the exhaustive re-match when that fails too.
    bad2 = res.fail[1] | (err[1] > 2.0 * KEYFRAME_ERR_THRESH)
    rel = torch.where(need_switch, res.pose[1], res.pose[0])
    new_carry, pose, switched, discarded = _settle(carry, cur, need_switch, rel, res.fail[1])
    # A failed re-match is a bad one, so ``deep`` covers ``discarded``.
    return new_carry, (pose, switched, discarded, need_switch & bad2), res.pose[1]


def _step(model: LaserModel, carry: _OdoCarry, cur: Scan):
    """One pass-1 odometry step (see :func:`_step_flagged`): ``(new_carry,
    (pose, switched, discarded, deep))``."""
    return _step_flagged(model, carry, cur)[:2]


def _step_deep(model: LaserModel, carry: _OdoCarry, cur: Scan, psm_rel: Tensor):
    """The step of a scan that :func:`_step_flagged` marked ``deep``,
    finished inline (the per-scan online frontends): a full ±π
    correlative match of ``cur`` against the previous scan replaces the
    banded estimate ``psm_rel``, and the step is settled from ``carry``,
    the carry before the flagged step.

    The step is *weak* when the exhaustive match is unconfident, and a
    *fracture* when it is unconfident and disagrees with the banded
    estimate (no dt-gap term here, unlike :func:`_deep_rematch_chunk`).
    Returns ``(new_carry, (pose, switched, discarded, weak, fracture))``,
    the last two including ``discarded``."""
    last1, cur1 = (Scan(*(x[None] for x in s)) for s in (carry.last, cur))
    corr = match_correlative(model, last1, cur1, search_xy=1.2, n_theta=72)
    ex, ey, _ = error_index(model, last1, cur1, corr.pose)
    err = torch.sqrt(ex + ey)[0]
    score, rel = corr.score[0], corr.pose[0]
    weak = (score < 0.4) | (err > 3.0 * KEYFRAME_ERR_THRESH)
    low_conf = (score < 0.35) | (err > 6.0 * KEYFRAME_ERR_THRESH)
    d = se2.relative(psm_rel, rel)
    disagree = (torch.sqrt(torch.sum(d[:2] ** 2)) > 0.5) | (
        torch.abs(se2.normalize_angle(d[2])) > 0.3
    )
    frac = low_conf & disagree
    switch = torch.ones_like(weak)
    new_carry, pose, switched, discarded = _settle(carry, cur, switch, rel, corr.fail[0])
    return new_carry, (pose, switched, discarded, weak | discarded, frac | discarded)


def _deep_rematch_chunk(
    model: LaserModel, ref: Scan, cur: Scan, prior: Tensor, dt_big: Tensor
):
    """Batched exhaustive fallback: full ±π correlative match of each
    (previous, current) pair ``[B, N]`` + confidence classification.

    ``prior [B, 3]`` is the banded matcher's placeholder estimate. A step
    is a *fracture* only when the exhaustive matcher is unconfident AND
    (disagrees with the banded estimate OR the step spans a dt gap)."""
    corr = match_correlative(model, ref, cur, search_xy=1.2, n_theta=72)
    ex, ey, _ = error_index(model, ref, cur, corr.pose)
    err = torch.sqrt(ex + ey)
    low_conf = (corr.score < 0.35) | (err > 6.0 * KEYFRAME_ERR_THRESH)
    weak = (corr.score < 0.4) | (err > 3.0 * KEYFRAME_ERR_THRESH)
    d = se2.relative(prior, corr.pose)
    disagree = (torch.sqrt(torch.sum(d[:, :2] ** 2, dim=-1)) > 0.5) | (
        torch.abs(se2.normalize_angle(d[:, 2])) > 0.3
    )
    frac = low_conf & (disagree | dt_big)
    return corr.pose, corr.fail, weak, frac


def _chain_steps(model: LaserModel, scans: Scan):
    """Pass 1 as a host loop of :func:`_step`: the plain version of
    ``odometry_chain_fused``. Returns ``(poses [T-1, 3], switched,
    discarded, deep_flag)``."""
    dev, dtype = scans.ranges.device, scans.ranges.dtype
    zero = torch.zeros(3, dtype=dtype, device=dev)
    first = Scan(*(x[0] for x in scans))
    carry = _OdoCarry(ref=first, last=first, ref_gpose=zero, last_gpose=zero,
                      prior_rel=zero)
    outs = []
    for i in range(1, scans.ranges.shape[0]):
        carry, out = _step(model, carry, Scan(*(x[i] for x in scans)))
        outs.append(out)
    if not outs:
        none = torch.zeros(0, dtype=torch.bool, device=dev)
        return torch.zeros(0, 3, dtype=dtype, device=dev), none, none, none
    return tuple(torch.stack(o) for o in zip(*outs))


def odometry_keyframe(
    model: LaserModel,
    scans: Scan,
    deep_chunk: int = 128,
    timestamps=None,
    chain: str = "fused",
) -> OdometryResult:
    """Keyframe odometry over a preprocessed ``[T, N]`` scan log on the
    scans' device.

    1. The keyframe chain, which flags steps whose banded matchers
       failed: on a CUDA device one launch of ``odometry_chain_fused``;
       on the CPU, and on a CUDA device with ``chain="steps"``, its plain
       version, a host loop of :func:`_step` (two PSM matches per step,
       no host sync).
    2. A host loop over chunks of ``deep_chunk`` flagged steps (padded
       with step 0, whose rows are thrown away) re-matched by a ±π
       correlative search, then a re-chaining of the per-step relatives.

    ``timestamps [T]`` (optional) drives frame-drop detection: a step
    whose dt exceeds 8× the median is weak, and inside the re-match it
    corroborates a fracture.
    """
    if chain not in ("fused", "steps"):
        raise ValueError(f"odometry_keyframe: chain must be 'fused' or 'steps', got {chain!r}")
    with trace("odometry.keyframe"):
        return _keyframe(model, scans, deep_chunk, timestamps, chain)


def _keyframe(model: LaserModel, scans: Scan, deep_chunk: int, timestamps, chain: str
              ) -> OdometryResult:
    dev, dtype = scans.ranges.device, scans.ranges.dtype
    t = scans.ranges.shape[0]
    zero = torch.zeros(3, dtype=dtype, device=dev)
    with trace("odometry.chain"):
        if dev.type == "cuda" and chain == "fused":
            poses, switched, discarded, deep_flag = odometry_chain_fused(
                model, scans, KEYFRAME_ERR_THRESH, 2.0 * KEYFRAME_ERR_THRESH)
        else:
            poses, switched, discarded, deep_flag = _chain_steps(model, scans)
        poses = torch.cat([zero[None], poses])

    with trace("odometry.flags_fetch"):             # waits for pass 1
        need = (deep_flag | discarded).cpu().numpy()   # steps 1..T-1
    weak = need.copy()
    disc = np.zeros(t - 1, bool)
    frac = np.zeros(t - 1, bool)
    if timestamps is not None:
        dts = np.diff(np.asarray(timestamps))
        med = max(float(np.median(dts)), 1e-6)
        dt_big = dts > 8.0 * med
        weak |= dt_big
    else:
        dt_big = np.zeros(t - 1, bool)

    idx = np.nonzero(need)[0]
    idxp = np.concatenate([idx, np.zeros((-idx.size) % deep_chunk, idx.dtype)])
    profiler.count("odometry.rematch_steps", idx.size)
    profiler.count("odometry.rematch_rows", idxp.size)     # with the padding
    if idx.size:
        with trace("odometry.rematch"):
            res = []
            for i in range(0, idxp.size, deep_chunk):
                sl = torch.as_tensor(idxp[i:i + deep_chunk], device=dev)
                res.append(_deep_rematch_chunk(
                    model,
                    Scan(*(x[sl] for x in scans)),
                    Scan(*(x[sl + 1] for x in scans)),
                    se2.relative(poses[sl], poses[sl + 1]),
                    torch.as_tensor(dt_big[idxp[i:i + deep_chunk]], device=dev),
                ))
            # Padded rows are thrown away.
            pose_r, fail_r, weak_r, frac_r = (torch.cat(x)[: idx.size] for x in zip(*res))
        with trace("odometry.rematch_fetch"):
            fail_np, weak_np, frac_np = (x.cpu().numpy() for x in (fail_r, weak_r, frac_r))
        ok = ~fail_np
        weak[idx] = weak_np | ~ok | dt_big[idx]
        disc[idx] = ~ok
        frac[idx] = frac_np | ~ok

    with trace("odometry.rechain"):
        if idx.size:
            rel = se2.relative(poses[:-1], poses[1:])
            steps = torch.as_tensor(idx, device=dev)
            use = torch.as_tensor(ok, device=dev)
            rel[steps] = torch.where(use[:, None], pose_r, rel[steps])
            poses = torch.cat([zero[None], se2.chain(rel)])

        rematched = np.zeros(t - 1, bool)
        rematched[idx] = True

        def flags(x) -> Tensor:
            x = torch.as_tensor(x, device=dev)
            return torch.cat([torch.zeros(1, dtype=torch.bool, device=dev), x])

        return OdometryResult(
            poses=poses,
            switched=flags(switched),
            discarded=flags(disc),
            weak=flags(weak),
            fracture=flags(frac),
            rematched=flags(rematched),
        )


def odometry_pairwise(model: LaserModel, scans: Scan, use_icp: bool = False) -> OdometryResult:
    """Batched consecutive-pair odometry: all ``T-1`` matches in one batch
    (PSM: one fused launch; polar ICP with ``use_icp``), then a log-depth
    pose chain."""
    ref = Scan(*(x[:-1] for x in scans))
    cur = Scan(*(x[1:] for x in scans))
    res = match_icp(model, ref, cur) if use_icp else match_psm_fused(model, ref, cur)
    rel = torch.where(res.fail[:, None], 0.0, res.pose)
    poses = se2.chain(rel)
    dev = poses.device
    f = torch.zeros(1, dtype=torch.bool, device=dev)
    return OdometryResult(
        poses=torch.cat([torch.zeros(1, 3, dtype=poses.dtype, device=dev), poses]),
        switched=torch.cat([f, torch.ones_like(res.fail)]),
        discarded=torch.cat([f, res.fail]),
        weak=torch.cat([f, res.fail]),
        fracture=torch.cat([f, res.fail]),
    )
