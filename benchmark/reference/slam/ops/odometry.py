"""Scan-matching odometry over a whole log, plain PyTorch only.

:func:`odometry_keyframe` — keyframe odometry in two passes: a sequential
chain of PSM matches with keyframe switching that only *flags* steps
whose banded matchers failed, then a batched ±π correlative re-match of
the flagged steps and a re-chaining.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import se2
from ..core.scan import LaserModel, Scan
from .correlative import match_correlative
from .psm import error_index, match_psm

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
    return Scan(*(torch.where(cond[..., None], x, y) for x, y in zip(a, b)))


def _match_and_score(model: LaserModel, ref: Scan, cur: Scan, init: Tensor, last: Scan):
    """The plain PSM match of ``cur`` against ``ref`` and its error index
    against ``last``."""
    res = match_psm(model, ref, cur, init)
    return res, error_index(model, last, cur, res.pose)


def _settle(carry: _OdoCarry, cur: Scan, need_switch: Tensor, rel: Tensor, all_failed: Tensor):
    """Settles a step from its chosen relative pose ``rel`` (against the
    keyframe, or against the previous scan when the keyframe switched):
    the new carry, the scan's global pose and the ``switched`` and
    ``discarded`` flags. A discarded frame leaves the carry as it was."""
    discarded = need_switch & all_failed
    keep = ~discarded
    switch3, keep3 = need_switch[..., None], keep[..., None]
    base = torch.where(switch3, carry.last_gpose, carry.ref_gpose)
    gpose = se2.compose(base, rel)
    new_carry = _OdoCarry(
        ref=_where_scan(need_switch & keep, carry.last, carry.ref),
        last=_where_scan(keep, cur, carry.last),
        ref_gpose=torch.where(keep3, base, carry.ref_gpose),
        last_gpose=torch.where(keep3, gpose, carry.last_gpose),
        prior_rel=torch.where(keep3, rel, carry.prior_rel),
    )
    out_pose = torch.where(keep3, gpose, carry.last_gpose)
    return new_carry, out_pose, need_switch & keep, discarded


def _step_flagged(model: LaserModel, carry: _OdoCarry, cur: Scan):
    """One odometry step with no host sync, the exhaustive fallback left
    to the caller.

    The keyframe match ``(ref, cur, prior_rel)`` and the switch-branch
    match ``(last, cur, 0)`` run as one fused PSM launch of two pairs,
    both error indices (against ``last``) with them; the branch is a
    select (both branches are pure, so the result equals a conditional).

    Returns ``(new_carry, (pose, switched, discarded, deep), psm_rel,
    iters)``, ``iters [2]`` the solver iterations of the two matches.
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
    rel = torch.where(need_switch[..., None], res.pose[1], res.pose[0])
    new_carry, pose, switched, discarded = _settle(carry, cur, need_switch, rel, res.fail[1])
    # A failed re-match is a bad one, so ``deep`` covers ``discarded``.
    return new_carry, (pose, switched, discarded, need_switch & bad2), res.pose[1], res.iters


def _step(model: LaserModel, carry: _OdoCarry, cur: Scan):
    """One pass-1 odometry step (see :func:`_step_flagged`): ``(new_carry,
    (pose, switched, discarded, deep), iters [2])``."""
    new_carry, out, _, iters = _step_flagged(model, carry, cur)
    return new_carry, out, iters


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
    """Pass 1 as a host loop of :func:`_step`. Returns ``(poses [T-1, 3],
    switched, discarded, deep_flag, iters [T-1, 2])``."""
    dev, dtype = scans.ranges.device, scans.ranges.dtype
    zero = torch.zeros(3, dtype=dtype, device=dev)
    first = Scan(*(x[0] for x in scans))
    carry = _OdoCarry(ref=first, last=first, ref_gpose=zero, last_gpose=zero,
                      prior_rel=zero)
    outs = []
    for i in range(1, scans.ranges.shape[0]):
        carry, out, iters = _step(model, carry, Scan(*(x[i] for x in scans)))
        outs.append((*out, iters))
    if not outs:
        none = torch.zeros(0, dtype=torch.bool, device=dev)
        return (torch.zeros(0, 3, dtype=dtype, device=dev), none, none, none,
                torch.zeros(0, 2, dtype=torch.int32, device=dev))
    return tuple(torch.stack(o) for o in zip(*outs))


def _step_lanes(model: LaserModel, carry: _OdoCarry, cur: Scan):
    """:func:`_step_flagged` for ``L`` independent chains at once (every
    field of ``carry`` and ``cur`` has a leading lane axis): the ``2L``
    matches run as one batch. Returns ``(new_carry, (pose, switched,
    discarded, deep), iters [L, 2])``."""
    n_lanes = cur.ranges.shape[0]

    def flat(s: Scan) -> Scan:
        return Scan(*(x.reshape(2 * n_lanes, -1) for x in s))

    res, (ex, ey, _) = _match_and_score(
        model, flat(_stack2(carry.ref, carry.last)), flat(_stack2(cur, cur)),
        torch.stack([carry.prior_rel, torch.zeros_like(carry.prior_rel)]).reshape(-1, 3),
        flat(_stack2(carry.last, carry.last)),
    )
    pose, fail = res.pose.reshape(2, n_lanes, 3), res.fail.reshape(2, n_lanes)
    err = torch.sqrt(ex + ey).reshape(2, n_lanes)
    need_switch = fail[0] | (err[0] > KEYFRAME_ERR_THRESH)
    bad2 = fail[1] | (err[1] > 2.0 * KEYFRAME_ERR_THRESH)
    rel = torch.where(need_switch[:, None], pose[1], pose[0])
    new_carry, out, switched, discarded = _settle(carry, cur, need_switch, rel, fail[1])
    return new_carry, (out, switched, discarded, need_switch & bad2), res.iters.reshape(2, -1).T


def chain_lanes(model: LaserModel, scans: Scan, every: int, overlap: int):
    """Pass 1 as chains run side by side, each from nothing but the scans.
    Lane ``k`` owns steps ``k·every + 1 .. (k+1)·every``; it starts
    ``overlap`` steps before them, at scan ``max(0, k·every - overlap)``,
    as the chain starts at the log's first scan (that scan the keyframe
    and the previous scan, a zero prior), and runs its own chain over the
    overlap before the steps it owns. Only the steps a lane owns are
    returned. Returns ``(rel [T-1, 3], switched, discarded, deep_flag,
    iters [T-1, 2])``, ``rel`` each step's pose relative to the previous
    scan."""
    dev, dtype = scans.ranges.device, scans.ranges.dtype
    t = scans.ranges.shape[0]
    owned = list(range(0, t - 1, every))
    warm = [max(0, s - overlap) for s in owned]
    ends = [min(s + every, t - 1) for s in owned]
    n_lanes = len(owned)
    first = torch.as_tensor(warm, device=dev)
    zero = torch.zeros(n_lanes, 3, dtype=dtype, device=dev)
    carry = _OdoCarry(
        ref=Scan(*(x[first] for x in scans)), last=Scan(*(x[first] for x in scans)),
        ref_gpose=zero, last_gpose=zero, prior_rel=zero)
    prev = zero
    outs = {}
    for j in range(1, max(e - w for w, e in zip(warm, ends)) + 1):
        idx = torch.as_tensor([min(w + j, e) for w, e in zip(warm, ends)], device=dev)
        carry, (pose, switched, discarded, deep), iters = _step_lanes(
            model, carry, Scan(*(x[idx] for x in scans)))
        rel = se2.relative(prev, pose)
        prev = pose
        for k, (w, s, e) in enumerate(zip(warm, owned, ends)):
            if s < w + j <= e:
                outs[w + j] = (rel[k], switched[k], discarded[k], deep[k], iters[k])
    steps = [outs[i] for i in range(1, t)]
    return tuple(torch.stack(o) for o in zip(*steps))


def odometry_keyframe(
    model: LaserModel,
    scans: Scan,
    deep_chunk: int = 128,
    timestamps=None,
    lanes: tuple[int, int] | None = None,
) -> tuple[OdometryResult, Tensor]:
    """Keyframe odometry over a preprocessed ``[T, N]`` scan log on the
    scans' device, in two passes:

    1. the keyframe chain, a host loop of :func:`_step` (two plain PSM
       matches per step), which flags steps whose banded matchers failed;
    2. a host loop over chunks of ``deep_chunk`` flagged steps (padded
       with step 0, whose rows are thrown away) re-matched by a ±π
       correlative search, then a re-chaining of the per-step relatives.

    ``timestamps [T]`` (optional) drives frame-drop detection: a step
    whose dt exceeds 8× the median is weak, and inside the re-match it
    corroborates a fracture. With ``lanes = (every, overlap)``, pass 1
    runs as :func:`chain_lanes`. Returns the result and pass 1's solver
    iterations ``[T-1, 2]``.
    """
    dev, dtype = scans.ranges.device, scans.ranges.dtype
    t = scans.ranges.shape[0]
    zero = torch.zeros(3, dtype=dtype, device=dev)
    if lanes is not None:
        rel, switched, discarded, deep_flag, iters = chain_lanes(model, scans, *lanes)
        poses = torch.cat([zero[None], se2.chain(rel)])
    else:
        poses, switched, discarded, deep_flag, iters = _chain_steps(model, scans)
        poses = torch.cat([zero[None], poses])
        rel = se2.relative(poses[:-1], poses[1:])

    need = (deep_flag | discarded).cpu().numpy()       # steps 1..T-1
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
    if idx.size:
        pad = (-idx.size) % deep_chunk
        idxp = np.concatenate([idx, np.zeros(pad, idx.dtype)])
        res = []
        for i in range(0, idxp.size, deep_chunk):
            sl = torch.as_tensor(idxp[i:i + deep_chunk], device=dev)
            res.append(_deep_rematch_chunk(
                model,
                Scan(*(x[sl] for x in scans)),
                Scan(*(x[sl + 1] for x in scans)),
                rel[sl],
                torch.as_tensor(dt_big[idxp[i:i + deep_chunk]], device=dev),
            ))
        # Padded rows are thrown away.
        pose_r, fail_r, weak_r, frac_r = (torch.cat(x)[: idx.size] for x in zip(*res))
        fail_np = fail_r.cpu().numpy()
        ok = ~fail_np
        weak[idx] = weak_r.cpu().numpy() | ~ok | dt_big[idx]
        disc[idx] = ~ok
        frac[idx] = frac_r.cpu().numpy() | ~ok

        rel = rel.clone()
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
    ), iters
