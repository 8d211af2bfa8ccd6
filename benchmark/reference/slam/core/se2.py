"""Batched SE(2) algebra on ``[..., 3]`` tensors ``(x, y, theta)``
(port of ``core/se2.py``), plus the numpy twins used by host code."""

from __future__ import annotations

import math

import numpy as np
import torch

Tensor = torch.Tensor


def normalize_angle(a: Tensor) -> Tensor:
    """Wrap angles to ``[-pi, pi)``."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def identity(batch_shape: tuple = (), dtype=torch.float32, device=None) -> Tensor:
    """The identity pose, optionally batched."""
    return torch.zeros(batch_shape + (3,), dtype=dtype, device=device)


def compose(a: Tensor, b: Tensor) -> Tensor:
    """Pose composition ``a ⊕ b``: pose ``b`` (given in ``a``'s frame)
    in the world frame."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = torch.cos(ath), torch.sin(ath)
    return torch.stack(
        [ax + c * bx - s * by, ay + s * bx + c * by, normalize_angle(ath + bth)],
        dim=-1,
    )


def inverse(a: Tensor) -> Tensor:
    """Pose inverse: ``inverse(a) ⊕ a == identity``."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    c, s = torch.cos(ath), torch.sin(ath)
    return torch.stack(
        [-(c * ax + s * ay), s * ax - c * ay, normalize_angle(-ath)], dim=-1
    )


def relative(a: Tensor, b: Tensor) -> Tensor:
    """Relative pose ``a ⊖ b``: world pose ``b`` in ``a``'s frame."""
    return compose(inverse(a), b)


def transform_points(pose: Tensor, pts: Tensor) -> Tensor:
    """Rigidly transform points ``[..., N, 2]`` by ``pose [..., 3]``."""
    x, y, th = pose[..., 0:1], pose[..., 1:2], pose[..., 2:3]
    c, s = torch.cos(th), torch.sin(th)
    px, py = pts[..., 0], pts[..., 1]
    return torch.stack([c * px - s * py + x, s * px + c * py + y], dim=-1)


def rotation_matrix(theta: Tensor) -> Tensor:
    """``[..., 2, 2]`` rotation matrices from angles."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack(
        [torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2
    )


def _v_coeffs(w: Tensor) -> tuple[Tensor, Tensor]:
    """``sin(w)/w`` and ``(1 - cos(w))/w`` with their Taylor limits for
    ``|w| < 1e-6``, each branch evaluated on a safe operand."""
    small = torch.abs(w) < 1e-6
    w_safe = torch.where(small, 1.0, w)
    a = torch.where(small, 1.0 - w * w / 6.0, torch.sin(w_safe) / w_safe)
    b = torch.where(small, w / 2.0, (1.0 - torch.cos(w_safe)) / w_safe)
    return a, b


def exp(tangent: Tensor) -> Tensor:
    """SE(2) exponential map from ``(vx, vy, omega)`` twists (closed-form
    V-matrix)."""
    vx, vy, w = tangent[..., 0], tangent[..., 1], tangent[..., 2]
    a, b = _v_coeffs(w)
    return torch.stack([a * vx - b * vy, b * vx + a * vy, normalize_angle(w)], dim=-1)


def log(pose: Tensor) -> Tensor:
    """SE(2) logarithm map (inverse of :func:`exp`)."""
    x, y, w = pose[..., 0], pose[..., 1], normalize_angle(pose[..., 2])
    a, b = _v_coeffs(w)
    det = a * a + b * b
    return torch.stack([(a * x + b * y) / det, (-b * x + a * y) / det, w], dim=-1)


def chain(rel_poses: Tensor, init: Tensor | None = None) -> Tensor:
    """Integrate a ``[T, 3]`` sequence of relative poses into absolute
    poses: ``out[t] = init ⊕ rel[0] ⊕ ... ⊕ rel[t]``.

    A log-depth doubling scan (Hillis–Steele): ``ceil(log2 T)`` batched
    compositions instead of ``T`` sequential ones.
    """
    out = rel_poses
    t = out.shape[0]
    d = 1
    while d < t:
        out = torch.cat([out[:d], compose(out[:-d], out[d:])], dim=0)
        d *= 2
    if init is not None:
        out = compose(init, out)
    return out


# -- NumPy twins (host-side bookkeeping) -----------------------------------

def np_normalize_angle(a):
    return np.mod(a + np.pi, 2.0 * np.pi) - np.pi


def np_relative(a, b):
    """Pose of ``b`` in ``a``'s frame."""
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = np.cos(ath), np.sin(ath)
    dx, dy = bx - ax, by - ay
    return np.stack(
        [c * dx + s * dy, -s * dx + c * dy, np_normalize_angle(bth - ath)],
        axis=-1,
    )


def np_compose(a, b):
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bth = b[..., 0], b[..., 1], b[..., 2]
    c, s = np.cos(ath), np.sin(ath)
    return np.stack(
        [ax + c * bx - s * by, ay + s * bx + c * by, np_normalize_angle(ath + bth)],
        axis=-1,
    )


def np_inverse(a):
    ax, ay, ath = a[..., 0], a[..., 1], a[..., 2]
    c, s = np.cos(ath), np.sin(ath)
    return np.stack(
        [-(c * ax + s * ay), s * ax - c * ay, np_normalize_angle(-ath)], axis=-1
    )
