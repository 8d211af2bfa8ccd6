"""Absolute trajectory error after SE(2) alignment, in numpy: a frozen
copy of the port's ``eval/metrics.ate`` arithmetic (2D Umeyama without
scale), in float64."""

from __future__ import annotations

import numpy as np


def align_se2(est_xy: np.ndarray, gt_xy: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rotation ``[2, 2]`` and translation ``[2]`` that best map
    ``est_xy [T, 2]`` onto ``gt_xy [T, 2]``."""
    e = est_xy - est_xy.mean(axis=0)
    g = gt_xy - gt_xy.mean(axis=0)
    sxx, syy = np.sum(e[:, 0] * g[:, 0]), np.sum(e[:, 1] * g[:, 1])
    sxy, syx = np.sum(e[:, 0] * g[:, 1]), np.sum(e[:, 1] * g[:, 0])
    th = np.arctan2(sxy - syx, sxx + syy)
    rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return rot, gt_xy.mean(axis=0) - rot @ est_xy.mean(axis=0)


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """Root mean square of the per-pose translation errors [m] of ``est
    [T, 3]`` against ``gt [T, 3]`` after alignment."""
    est = np.asarray(est, np.float64)[:, :2]
    gt = np.asarray(gt, np.float64)[:, :2]
    rot, t = align_se2(est, gt)
    err = np.sqrt(np.sum((est @ rot.T + t - gt) ** 2, axis=-1))
    return float(np.sqrt(np.mean(err ** 2)))
