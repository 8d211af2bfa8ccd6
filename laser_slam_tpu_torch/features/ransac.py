"""Batched-hypothesis RANSAC SE(2) matching of feature sets (port of
``features/ransac.py``), batched over pairs.

The sample-until-confident loop becomes a fixed batch of ``H``
hypotheses per pair: sample ``H`` pairs of candidate correspondences, a
closed-form SE(2) from each two-point sample, all ``H × K`` inlier tests
at once, the best hypothesis refined on its inliers by a weighted Kabsch
solve. Edge information is ``1/err``.

The sampling is split: :func:`draw_hypotheses` draws the hypothesis
indices from an explicit ``torch.Generator``, and :func:`match_features_at`
is the deterministic rest, which takes them (a test feeds it another
generator's draws). :func:`match_features` is the two in a row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se2
from .descriptor import descriptor_distance
from .detector import FeatureSet

Tensor = torch.Tensor

N_HYPOTHESES = 128
DESC_MATCH_THRESH = 0.8   # max descriptor χ² for a candidate correspondence
INLIER_DIST = 0.4         # [m] acceptance distance
MIN_INLIERS = 5


class FeatureMatchResult(NamedTuple):
    pose: Tensor        # [B, 3] SE(2) pose of set B's frame in set A's frame
    n_inliers: Tensor   # [B] int32
    err: Tensor         # [B] mean inlier residual after refinement (m)
    fail: Tensor        # [B] bool
    information: Tensor # [B] scalar edge information = 1 / err


def _two_point_se2(pa: Tensor, pb: Tensor, qa: Tensor, qb: Tensor) -> Tensor:
    """Closed-form SE(2) aligning segments ``(qa, qb)`` onto ``(pa, pb)``
    (``[..., 2]`` each): rotation from the segment directions, translation
    from the midpoints."""
    dp, dq = pb - pa, qb - qa
    th = torch.atan2(dp[..., 1], dp[..., 0]) - torch.atan2(dq[..., 1], dq[..., 0])
    c, s = torch.cos(th), torch.sin(th)
    mq, mp = 0.5 * (qa + qb), 0.5 * (pa + pb)
    tx = mp[..., 0] - (c * mq[..., 0] - s * mq[..., 1])
    ty = mp[..., 1] - (s * mq[..., 0] + c * mq[..., 1])
    return torch.stack([tx, ty, th], dim=-1)


def candidate_correspondences(fa: FeatureSet, da: Tensor, fb: FeatureSet, db: Tensor):
    """Every feature of B's best descriptor match in A: ``(j_best [B, Kb],
    corr_ok [B, Kb], logits [B, Kb])``; ``logits`` is the log of the
    sampling weights, ~0 probability for a feature without a match."""
    dist = descriptor_distance(db, da)                            # [B, Kb, Ka]
    pair_ok = fb.valid[..., :, None] & fa.valid[..., None, :]
    dist = torch.where(pair_ok, dist, torch.inf)
    j_best = torch.argmin(dist, dim=-1)                           # first on ties
    d_best = torch.gather(dist, -1, j_best[..., None])[..., 0]
    corr_ok = torch.isfinite(d_best) & (d_best < DESC_MATCH_THRESH)
    w = corr_ok.to(fa.xy.dtype) + 1e-6
    return j_best, corr_ok, torch.log(w / torch.sum(w, dim=-1, keepdim=True))


def draw_hypotheses(logits: Tensor, generator: torch.Generator,
                    n_hypotheses: int = N_HYPOTHESES) -> tuple[Tensor, Tensor]:
    """Two independent categorical draws of ``n_hypotheses`` indices per
    pair from ``logits [B, K]``: ``(i1, i2)`` ``[B, H]``."""
    p = torch.softmax(logits, dim=-1)
    return tuple(torch.multinomial(p, n_hypotheses, replacement=True, generator=generator)
                 for _ in range(2))


def match_features_at(
    fa: FeatureSet, da: Tensor, fb: FeatureSet, db: Tensor, i1: Tensor, i2: Tensor,
) -> FeatureMatchResult:
    """RANSAC-match each feature set B onto A (``[B, K, ...]`` sets, ``[B,
    K, D]`` descriptors) from the hypothesis indices ``i1, i2 [B, H]``
    into B's candidate correspondences; returns B's frame in A's frame."""
    k = fb.xy.shape[-2]
    dtype = fa.xy.dtype
    j_best, corr_ok, _ = candidate_correspondences(fa, da, fb, db)
    qs = fb.xy                                                    # [B, K, 2] source
    ps = torch.gather(fa.xy, 1, j_best[..., None].expand(-1, -1, 2))   # target

    def at(x, i):
        return torch.gather(x, 1, i[..., None].expand(-1, -1, 2))

    distinct = (i1 != i2) & torch.gather(corr_ok, 1, i1) & torch.gather(corr_ok, 1, i2)
    hyp = _two_point_se2(at(ps, i1), at(ps, i2), at(qs, i1), at(qs, i2))    # [B, H, 3]

    # Every hypothesis against every candidate correspondence.
    q_h = se2.transform_points(hyp, qs[:, None])                  # [B, H, K, 2]
    d = q_h - ps[:, None]
    res = torch.sqrt(torch.sum(d * d, dim=-1))                    # [B, H, K]
    inl = (res < INLIER_DIST) & corr_ok[:, None, :] & distinct[..., None]
    n_inl = torch.sum(inl, dim=-1)
    # Equal inlier counts are told apart by the total inlier residual.
    score = n_inl.to(dtype) - torch.sum(torch.where(inl, res, 0.0), dim=-1) / (INLIER_DIST * k)
    h_best = torch.argmax(score, dim=-1)                          # first on ties
    rows = torch.arange(h_best.shape[0], device=h_best.device)
    inliers = inl[rows, h_best]                                   # [B, K]
    n = n_inl[rows, h_best]

    # Weighted Kabsch refinement on the winning inlier set.
    wk = inliers.to(dtype)
    m = torch.clamp(torch.sum(wk, dim=-1), min=1.0)
    mq = torch.sum(qs * wk[..., None], dim=1) / m[:, None]
    mp = torch.sum(ps * wk[..., None], dim=1) / m[:, None]
    dq = (qs - mq[:, None]) * wk[..., None]
    dp = ps - mp[:, None]
    sxx = torch.sum(dq[..., 0] * dp[..., 0], dim=-1)
    sxy = torch.sum(dq[..., 0] * dp[..., 1], dim=-1)
    syx = torch.sum(dq[..., 1] * dp[..., 0], dim=-1)
    syy = torch.sum(dq[..., 1] * dp[..., 1], dim=-1)
    th = torch.atan2(sxy - syx, sxx + syy)
    c, s = torch.cos(th), torch.sin(th)
    tx = mp[:, 0] - (c * mq[:, 0] - s * mq[:, 1])
    ty = mp[:, 1] - (s * mq[:, 0] + c * mq[:, 1])
    pose = torch.stack([tx, ty, th], dim=-1)

    qr = se2.transform_points(pose, qs) - ps
    err = torch.sum(torch.where(inliers, torch.sqrt(torch.sum(qr * qr, dim=-1)), 0.0), dim=-1) / m
    fail = n < MIN_INLIERS
    return FeatureMatchResult(
        pose=torch.where(fail[:, None], 0.0, pose),
        n_inliers=n.to(torch.int32),
        err=torch.where(fail, torch.inf, err),
        fail=fail,
        information=torch.where(fail, 0.0, 1.0 / torch.clamp(err, min=1e-4)),
    )


def match_features(
    fa: FeatureSet, da: Tensor, fb: FeatureSet, db: Tensor,
    generator: torch.Generator, n_hypotheses: int = N_HYPOTHESES,
) -> FeatureMatchResult:
    """:func:`draw_hypotheses` from ``generator``, then
    :func:`match_features_at`."""
    _, _, logits = candidate_correspondences(fa, da, fb, db)
    i1, i2 = draw_hypotheses(logits, generator, n_hypotheses)
    return match_features_at(fa, da, fb, db, i1, i2)
