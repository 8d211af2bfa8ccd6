"""Unscented Kalman filtering for multi-sensor pose fusion (port of
``fusion/ukf.py``).

The filter fuses scan-matcher poses, odometry increments, beacon fixes
and a nonlinear GPS range model into an SE(2) state:

- :func:`predict` — near-identity motion with (large) additive process
  noise;
- :func:`update_pose` — full-pose linear observation with angle wrapping;
- :func:`update_partial` — observe any linear slice of the state (beacon
  x/y fixes);
- :func:`update_nonlinear` — generic unscented update for nonlinear
  models (the GPS range observe).

All functions are pure ``(state, ...) -> state`` on the device of the
state's tensors. Nothing here reads a value back to the host: the
factorisation and the inverse are the ``_ex`` variants, which leave their
error flag on the device, every branch is a ``torch.where`` over whole
states, and every ``.at[].set`` of the original is an out-of-place build,
so a state that another object still references never changes.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..core import se2

Tensor = torch.Tensor

# Unscented transform parameters (Julier's symmetric set with the
# customary scaling; kappa defaults to 3 - n).
ALPHA = 1e-1
BETA = 2.0


class UkfState(NamedTuple):
    mean: Tensor  # [D]
    cov: Tensor   # [D, D]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]


def _eye(d: int, like: Tensor) -> Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _noise(x: Tensor | float, d: int, like: Tensor) -> Tensor:
    """A ``[d, d]`` noise matrix from a matrix or a scalar variance."""
    if isinstance(x, Tensor) and x.dim() > 0:
        return x.to(like.dtype)
    return _eye(d, like) * x


def init(mean: Tensor, cov: Tensor | float, device=None) -> UkfState:
    """A filter state on ``device`` (default: the device of ``mean``)."""
    mean = torch.as_tensor(mean, dtype=torch.float32)
    if device is not None:
        mean = mean.to(device)
    return UkfState(mean=mean, cov=_noise(torch.as_tensor(cov, device=mean.device), mean.shape[0], mean))


def _sigma_points(state: UkfState) -> tuple[Tensor, Tensor, Tensor]:
    """Symmetric sigma points ``[2D+1, D]`` + mean/cov weights."""
    d = state.dim
    lam = ALPHA * ALPHA * (d + 3.0 - d) - d
    scale = d + lam
    sqrt_cov = torch.linalg.cholesky_ex(
        state.cov * scale + 1e-9 * _eye(d, state.mean)
    ).L
    pts = torch.cat(
        [
            state.mean[None, :],
            state.mean[None, :] + sqrt_cov.T,
            state.mean[None, :] - sqrt_cov.T,
        ],
        dim=0,
    )
    w = [lam / scale] + [1.0 / (2.0 * scale)] * (2 * d)
    wm = torch.tensor(w, dtype=state.mean.dtype, device=state.mean.device)
    w[0] += 1.0 - ALPHA * ALPHA + BETA
    wc = torch.tensor(w, dtype=state.mean.dtype, device=state.mean.device)
    return pts, wm, wc


def predict(
    state: UkfState,
    motion: Tensor | None = None,
    q: Tensor | float = 1.0,
) -> UkfState:
    """Propagate by an (optional) SE(2) increment and inflate covariance.

    With ``motion=None`` this is the near-identity predict with large Q:
    the state barely moves, uncertainty grows, and the observations do
    the work.
    """
    d = state.dim
    q = _noise(q, d, state.mean)
    if motion is None:
        return UkfState(mean=state.mean, cov=state.cov + q)
    mean = se2.compose(state.mean, motion)
    # Jacobian of compose wrt the state at (mean, motion).
    c, s = torch.cos(state.mean[2]), torch.sin(state.mean[2])
    mx, my = motion[0], motion[1]
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    F = torch.stack(
        [
            torch.stack([one, zero, -s * mx - c * my]),
            torch.stack([zero, one, c * mx - s * my]),
            torch.stack([zero, zero, one]),
        ]
    )
    cov = F @ state.cov @ F.T + q
    return UkfState(mean=mean, cov=cov)


def _joseph_update(state: UkfState, H: Tensor, innov: Tensor, R: Tensor) -> UkfState:
    S = H @ state.cov @ H.T + R
    K = state.cov @ H.T @ torch.linalg.inv_ex(S).inverse
    mean = state.mean + K @ innov
    ikh = _eye(state.dim, state.mean) - K @ H
    cov = ikh @ state.cov @ ikh.T + K @ R @ K.T
    return UkfState(mean=mean, cov=cov)


def _wrap_heading(v: Tensor) -> Tensor:
    """``v [3]`` with its third entry wrapped to ``[-pi, pi)``."""
    return torch.cat([v[:2], se2.normalize_angle(v[2:3])])


def update_pose(state: UkfState, z: Tensor, r: Tensor | float) -> UkfState:
    """Observe the full SE(2) pose (scan-matcher / global-sync observes),
    wrapping the angle innovation."""
    r = _noise(r, 3, state.mean)
    H = _eye(3, state.mean)
    innov = _wrap_heading(z - state.mean)
    out = _joseph_update(state, H, innov, r)
    return UkfState(mean=_wrap_heading(out.mean), cov=out.cov)


def update_partial(
    state: UkfState, idx: tuple[int, ...], z: Tensor, r: Tensor | float
) -> UkfState:
    """Observe a linear slice of the state (e.g. a beacon (x, y) fix)."""
    k = len(idx)
    r = _noise(r, k, state.mean)
    H = _eye(state.dim, state.mean)[list(idx)]
    innov = z - state.mean[list(idx)]
    return _joseph_update(state, H, innov, r)


def update_nonlinear(
    state: UkfState,
    h: Callable[[Tensor], Tensor],
    z: Tensor,
    r: Tensor | float,
) -> UkfState:
    """Generic unscented update for a nonlinear observation ``h(x)`` (the
    GPS range model). ``h`` takes the sigma points as one batch
    ``[2D+1, D]`` and returns ``[2D+1]`` or ``[2D+1, K]``."""
    pts, wm, wc = _sigma_points(state)
    zs = h(pts)                                            # [2D+1, K]
    if zs.dim() == 1:
        zs = zs[:, None]
        z = torch.atleast_1d(z)
    k = zs.shape[1]
    r = _noise(r, k, state.mean)
    z_mean = torch.sum(wm[:, None] * zs, dim=0)
    dz = zs - z_mean[None, :]
    dx = pts - state.mean[None, :]
    S = torch.einsum("n,ni,nj->ij", wc, dz, dz) + r
    C = torch.einsum("n,ni,nj->ij", wc, dx, dz)
    K = C @ torch.linalg.inv_ex(S).inverse
    mean = state.mean + K @ (z - z_mean)
    cov = state.cov - K @ S @ K.T
    return UkfState(mean=mean, cov=cov)


class FusionInputs(NamedTuple):
    """One fusion tick's gated sensor data (each sensor is gated by the
    freshness of its timestamp). Invalid sensors are masked, so a tick is
    the same sequence of device operations whatever arrived.

    Timestamps default to +inf ("always fresh") so timestamp-free
    callers keep the ungated behavior; a live pipeline stamps each
    observation with its capture time (seconds, any common origin)."""

    odom_rel: Tensor      # [3] odometry increment since last tick
    odom_valid: Tensor    # [] bool
    slam_pose: Tensor     # [3] scan-matcher pose
    slam_valid: Tensor    # [] bool
    beacon_xy: Tensor     # [2]
    beacon_valid: Tensor  # [] bool
    slam_t: Tensor | float = math.inf    # [] capture time of the SLAM pose
    beacon_t: Tensor | float = math.inf  # [] capture time of the beacon fix


def _select(cond: Tensor, a: UkfState, b: UkfState) -> UkfState:
    return UkfState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def fusion_step(
    state: UkfState,
    inp: FusionInputs,
    q: float = 0.05,
    r_slam: float = 0.02,
    r_beacon: float = 0.25,
    filter_t: Tensor | float = -math.inf,
) -> tuple[UkfState, Tensor]:
    """One fused tick: predict by odometry, then apply whichever
    observations are fresh.

    The filter tracks the time of the newest observation it consumed and
    takes a sensor's observation only when it is *newer*: one stamped at
    or before ``filter_t`` is stale (already consumed, or delivered out of
    order after the filter advanced past it) and is skipped. Returns
    ``(state, new_filter_t)``; pass the returned time into the next tick.
    Callers that never stamp observations (all defaults) get the
    always-fresh behavior.
    """
    mean = state.mean

    def scalar(x):
        return torch.as_tensor(x, dtype=mean.dtype, device=mean.device)

    filter_t, slam_t, beacon_t = scalar(filter_t), scalar(inp.slam_t), scalar(inp.beacon_t)
    motion = torch.where(inp.odom_valid, inp.odom_rel, torch.zeros_like(inp.odom_rel))
    state = predict(state, motion, q)

    slam_fresh = inp.slam_valid & (slam_t > filter_t)
    state = _select(slam_fresh, update_pose(state, inp.slam_pose, r_slam), state)
    beacon_fresh = inp.beacon_valid & (beacon_t > filter_t)
    state = _select(beacon_fresh, update_partial(state, (0, 1), inp.beacon_xy, r_beacon), state)
    consumed = torch.stack(
        [
            torch.where(slam_fresh & torch.isfinite(slam_t), slam_t, filter_t),
            torch.where(beacon_fresh & torch.isfinite(beacon_t), beacon_t, filter_t),
        ]
    )
    return state, torch.max(consumed)
