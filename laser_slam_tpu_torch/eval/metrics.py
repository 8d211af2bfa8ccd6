"""Trajectory accuracy metrics: ATE after SE(2) alignment and relative
pose error (port of ``eval/metrics.py``)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import se2

Tensor = torch.Tensor


class AteResult(NamedTuple):
    rmse: Tensor
    mean: Tensor
    median: Tensor
    max: Tensor


def align_se2(est_xy: Tensor, gt_xy: Tensor) -> tuple[Tensor, Tensor]:
    """Optimal rotation+translation aligning ``est_xy [T,2]`` onto
    ``gt_xy [T,2]`` (2D Umeyama without scale). Returns ``(R, t)``."""
    mu_e = torch.mean(est_xy, dim=0)
    mu_g = torch.mean(gt_xy, dim=0)
    e = est_xy - mu_e
    g = gt_xy - mu_g
    sxx = torch.sum(e[:, 0] * g[:, 0])
    syy = torch.sum(e[:, 1] * g[:, 1])
    sxy = torch.sum(e[:, 0] * g[:, 1])
    syx = torch.sum(e[:, 1] * g[:, 0])
    rot = se2.rotation_matrix(torch.atan2(sxy - syx, sxx + syy))
    return rot, mu_g - rot @ mu_e


def ate(est: Tensor, gt: Tensor) -> AteResult:
    """Absolute trajectory error of ``est [T,3]`` vs ``gt [T,3]`` after
    SE(2) alignment; statistics over per-pose translation errors [m]."""
    rot, t = align_se2(est[:, :2], gt[:, :2])
    aligned = est[:, :2] @ rot.T + t
    errs = torch.sqrt(torch.sum((aligned - gt[:, :2]) ** 2, dim=-1))
    return AteResult(
        rmse=torch.sqrt(torch.mean(errs ** 2)),
        mean=torch.mean(errs),
        # The mean of the two middle values for an even count, like
        # numpy's median (torch.median returns the lower one).
        median=torch.quantile(errs, 0.5),
        max=torch.max(errs),
    )


def rpe(est: Tensor, gt: Tensor, delta: int = 1) -> tuple[Tensor, Tensor]:
    """Relative pose error at step ``delta``: per-pair translation [m] and
    rotation [rad] error arrays."""
    rel_e = se2.relative(est[:-delta], est[delta:])
    rel_g = se2.relative(gt[:-delta], gt[delta:])
    d = se2.relative(rel_g, rel_e)
    return (
        torch.sqrt(torch.sum(d[:, :2] ** 2, dim=-1)),
        torch.abs(se2.normalize_angle(d[:, 2])),
    )
