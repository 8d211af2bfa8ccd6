"""Accuracy diagnostics: where does residual trajectory error live?
(port of ``eval/diagnostics.py``; numpy on the host).

An aggregate ATE of several meters with hundreds of accepted loops means
the error is *structured*: concentrated in uncovered trajectory spans,
in orientation drift between anchors, or in wrong loops bending the
solve. Each cause needs a different fix:

- :func:`segment_errors` — per-segment translation/heading error after
  one global alignment (which spans are bad?);
- :func:`loop_coverage` — per-anchor count of bank loops (which spans
  are unconstrained?);
- :func:`classify_loops` — each loop's measured relative pose checked
  against ground truth (how many accepted loops are wrong, by how much?).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..core import se2


class SegmentErrors(NamedTuple):
    seg_start: np.ndarray   # [S] first scan index of each segment
    t_rmse: np.ndarray      # [S] translation RMSE [m] within the segment
    t_max: np.ndarray       # [S]
    h_mean: np.ndarray      # [S] mean |heading error| [rad]


def _align_se2(est_xy: np.ndarray, gt_xy: np.ndarray):
    """The ATE alignment (2D Umeyama without scale) in numpy float32:
    ``(R [2, 2], t [2])``."""
    est_xy, gt_xy = np.asarray(est_xy, np.float32), np.asarray(gt_xy, np.float32)
    mu_e, mu_g = est_xy.mean(axis=0), gt_xy.mean(axis=0)
    e, g = est_xy - mu_e, gt_xy - mu_g
    th = np.arctan2(
        np.sum(e[:, 0] * g[:, 1]) - np.sum(e[:, 1] * g[:, 0]),
        np.sum(e[:, 0] * g[:, 0]) + np.sum(e[:, 1] * g[:, 1]),
    )
    c, s = np.cos(th), np.sin(th)
    rot = np.asarray([[c, -s], [s, c]], np.float32)
    return rot, mu_g - rot @ mu_e


def aligned_errors(est: np.ndarray, gt: np.ndarray):
    """Per-pose translation error [T] and heading error [T] after one
    global SE(2) alignment of ``est`` onto ``gt`` (the ATE alignment)."""
    rot, t = _align_se2(est[:, :2], gt[:, :2])
    xy = est[:, :2] @ rot.T + t
    terr = np.linalg.norm(xy - gt[:, :2], axis=-1)
    dtheta = float(np.arctan2(rot[1, 0], rot[0, 0]))
    herr = se2.np_normalize_angle(est[:, 2] + dtheta - gt[:, 2])
    return terr, herr


def segment_errors(est: np.ndarray, gt: np.ndarray, seg_len: int = 100) -> SegmentErrors:
    """Per-segment breakdown of globally-aligned trajectory error."""
    terr, herr = aligned_errors(est, gt)
    t = est.shape[0]
    starts = np.arange(0, t, seg_len)
    t_rmse, t_max, h_mean = [], [], []
    for s in starts:
        sl = slice(s, min(s + seg_len, t))
        t_rmse.append(float(np.sqrt(np.mean(terr[sl] ** 2))))
        t_max.append(float(np.max(terr[sl])))
        h_mean.append(float(np.mean(np.abs(herr[sl]))))
    return SegmentErrors(
        seg_start=starts,
        t_rmse=np.asarray(t_rmse),
        t_max=np.asarray(t_max),
        h_mean=np.asarray(h_mean),
    )


def loop_coverage(
    src: np.ndarray, dst: np.ndarray, active: np.ndarray, n_anchors: int
) -> np.ndarray:
    """[A] count of active bank loops touching each anchor."""
    cov = np.zeros(n_anchors, np.int32)
    np.add.at(cov, src[active], 1)
    np.add.at(cov, dst[active], 1)
    return cov


class LoopReport(NamedTuple):
    n: int                 # active loops
    n_correct: int         # |rel - rel_gt| within tolerance
    t_err: np.ndarray      # [n] translation error vs GT [m]
    r_err: np.ndarray      # [n] rotation error vs GT [rad]
    gap: np.ndarray        # [n] anchor index gap
    src: np.ndarray
    dst: np.ndarray


def classify_loops(
    src: np.ndarray,
    dst: np.ndarray,
    rel: np.ndarray,
    active: np.ndarray,
    gt_anchor: np.ndarray,
    t_tol: float = 0.5,
    r_tol: float = 0.2,
) -> LoopReport:
    """Check each active loop's measured relative pose against the
    ground-truth relative pose of its anchors (float32, as the poses)."""
    s = src[active]
    d = dst[active]
    gt_anchor = np.asarray(gt_anchor, np.float32)
    rel_gt = se2.np_compose(se2.np_inverse(gt_anchor[s]), gt_anchor[d])
    diff = se2.np_compose(se2.np_inverse(rel_gt), np.asarray(rel, np.float32)[active])
    t_err = np.linalg.norm(diff[:, :2], axis=-1)
    r_err = np.abs(se2.np_normalize_angle(diff[:, 2]))
    correct = (t_err < t_tol) & (r_err < r_tol)
    return LoopReport(
        n=int(active.sum()),
        n_correct=int(correct.sum()),
        t_err=t_err,
        r_err=r_err,
        gap=np.abs(d.astype(np.int64) - s.astype(np.int64)),
        src=s,
        dst=d,
    )
