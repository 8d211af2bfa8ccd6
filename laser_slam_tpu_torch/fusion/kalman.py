"""Covariance (EKF) and UdU-factorized Kalman filtering (port of
``fusion/kalman.py``).

- The covariance filter keeps a dense symmetric ``[D, D]`` matrix and
  observes in the Joseph form; a nonlinear model is linearized with
  ``torch.func.jacfwd`` at the current mean.
- The UdU filter stores the factors ``U`` (unit upper-triangular) and
  ``d`` (diagonal) explicitly: factorization, Bierman's rank-1 observe
  and Thornton's (MWG-S) predict are Python loops over the small, static
  state dimension.

All functions are pure ``(state, ...) -> state`` on the device of the
state's tensors, and read nothing back to the host (the solves are the
``_ex`` variants).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
from torch.func import jacfwd

Tensor = torch.Tensor


def _eye(d: int, like: Tensor) -> Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _matrix(x: Tensor | float, d: int, like: Tensor) -> Tensor:
    """A ``[d, d]`` matrix from a matrix or a scalar (times the identity)."""
    if isinstance(x, Tensor) and x.dim() > 0:
        return x.to(like.dtype)
    return _eye(d, like) * x


def _mean(mean, device) -> Tensor:
    mean = torch.as_tensor(mean, dtype=torch.float32)
    return mean if device is None else mean.to(device)


# ---------------------------------------------------------------------------
# Covariance (extended Kalman) filter
# ---------------------------------------------------------------------------


class KalmanState(NamedTuple):
    mean: Tensor  # [D]
    cov: Tensor   # [D, D]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]


def init(mean: Tensor, cov: Tensor | float, device=None) -> KalmanState:
    """A filter state on ``device`` (default: the device of ``mean``)."""
    mean = _mean(mean, device)
    cov = torch.as_tensor(cov, dtype=torch.float32, device=mean.device)
    return KalmanState(mean, _matrix(cov, mean.shape[0], mean))


def predict_linear(state: KalmanState, F: Tensor, q: Tensor | float) -> KalmanState:
    """Linear(ized) predict ``x <- F x``, ``P <- F P Fᵀ + Q``."""
    Q = _matrix(q, state.dim, state.mean)
    return KalmanState(F @ state.mean, F @ state.cov @ F.T + Q)


def predict(state: KalmanState, f: Callable[[Tensor], Tensor], q: Tensor | float) -> KalmanState:
    """Nonlinear predict: propagate the mean through ``f`` (a torch
    function) and linearize it with ``torch.func.jacfwd``."""
    # jacfwd may return a float32 function's Jacobian in float64.
    F = jacfwd(f)(state.mean).to(state.mean.dtype)
    Q = _matrix(q, state.dim, state.mean)
    return KalmanState(f(state.mean), F @ state.cov @ F.T + Q)


def update_linear(state: KalmanState, H: Tensor, innov: Tensor, r: Tensor | float) -> KalmanState:
    """Joseph-form linear observe (numerically symmetric)."""
    R = _matrix(r, H.shape[0], state.mean)
    S = H @ state.cov @ H.T + R
    K = torch.linalg.solve_ex(S, H @ state.cov)[0].T
    mean = state.mean + K @ innov
    ikh = _eye(state.dim, state.mean) - K @ H
    cov = ikh @ state.cov @ ikh.T + K @ R @ K.T
    return KalmanState(mean, cov)


def update(state: KalmanState, h: Callable[[Tensor], Tensor], z: Tensor, r: Tensor | float) -> KalmanState:
    """Nonlinear observe, linearized at the current mean."""
    H = torch.atleast_2d(jacfwd(h)(state.mean)).to(state.mean.dtype)
    innov = torch.atleast_1d(z - h(state.mean))
    return update_linear(state, H, innov, r)


# ---------------------------------------------------------------------------
# UdU factorization utilities
# ---------------------------------------------------------------------------


class UdState(NamedTuple):
    """Square-root filter state: ``P = U diag(d) Uᵀ`` with ``U`` unit
    upper-triangular."""

    mean: Tensor  # [D]
    U: Tensor     # [D, D] unit upper-triangular
    d: Tensor     # [D]

    @property
    def dim(self) -> int:
        return self.mean.shape[0]

    def cov(self) -> Tensor:
        return (self.U * self.d[None, :]) @ self.U.T


def udu_factorize(P: Tensor) -> tuple[Tensor, Tensor]:
    """Factor a symmetric PSD matrix as ``P = U diag(d) Uᵀ``, from the
    last column to the first (a rank-1 downdate of the leading block per
    column)."""
    n = P.shape[0]
    U = torch.zeros_like(P)
    d = torch.zeros(n, dtype=P.dtype, device=P.device)
    lead = torch.arange(n, device=P.device)
    for j in range(n - 1, -1, -1):
        dj = P[j, j]
        d[j] = dj
        safe = torch.where(dj > 0, dj, 1.0)
        # A true division by the pivot, as the reference computes it.
        col = torch.where(lead < j, P[:, j] / safe, 0.0)
        col = torch.where(dj > 0, col, 0.0)
        U[:, j] = col
        U[j, j] = 1.0
        P = P - dj * torch.outer(col, col)
    return U, d


def ud_init(mean: Tensor, cov: Tensor | float, device=None) -> UdState:
    """A square-root filter state on ``device`` (default: the device of
    ``mean``)."""
    mean = _mean(mean, device)
    cov = torch.as_tensor(cov, dtype=torch.float32, device=mean.device)
    U, d = udu_factorize(_matrix(cov, mean.shape[0], mean))
    return UdState(mean, U, d)


def bierman_update(state: UdState, h_row: Tensor, innov: Tensor, r_scalar: Tensor | float) -> UdState:
    """Bierman's rank-1 scalar observe on the U-d factors: ``h_row`` is
    the ``[D]`` observation row, ``innov`` the scalar innovation,
    ``r_scalar`` its variance. The covariance is never formed."""
    f = state.U.T @ h_row            # f = Uᵀ h
    g = state.d * f                  # g = D f
    fg, nf = f * g, -f
    alpha = torch.as_tensor(r_scalar, dtype=state.d.dtype, device=state.d.device)
    alpha_safe = torch.where(alpha > 0, alpha, 1.0)
    b = torch.zeros_like(state.d)
    cols, scale = [], []
    for j in range(state.dim):
        beta = alpha + fg[j]
        beta_safe = torch.where(beta > 0, beta, 1.0)
        scale.append(alpha / beta_safe)
        p = nf[j] / alpha_safe
        col = state.U[:, j]
        cols.append(col + p * b)     # column update: U[:, j] += p b
        b = b + g[j] * col           # b += g[j] U_old[:, j]
        alpha, alpha_safe = beta, beta_safe
    gain = b / alpha_safe
    return UdState(state.mean + gain * innov, torch.stack(cols, dim=1),
                   state.d * torch.stack(scale))


def thornton_predict(state: UdState, F: Tensor, q_diag: Tensor) -> UdState:
    """Modified weighted Gram-Schmidt (Thornton) time update through
    ``x <- F x`` with diagonal process noise ``Q = diag(q_diag)``: the
    rows of ``W = [F U | I]`` under the weights ``[d | q]`` are
    re-orthogonalized into fresh U-d factors, from the last row to the
    first."""
    n = state.dim
    W = torch.cat([F @ state.U, _eye(n, state.U)], dim=1)
    w = torch.cat([state.d, torch.as_tensor(q_diag, dtype=state.d.dtype, device=state.d.device)])
    U = _eye(n, state.U)
    ds = []
    for j in range(n - 1, -1, -1):
        row = W[j]
        wr = w * row
        dj = torch.sum(wr * row)
        ds.append(dj)
        proj = W[:j] @ wr / torch.where(dj > 0, dj, 1.0)   # projections of the rows above
        U[:j, j] = proj
        W = torch.cat([W[:j] - proj[:, None] * row[None, :], W[j:]])
    return UdState(F @ state.mean, U, torch.stack(ds[::-1]))


def ud_update(state: UdState, H: Tensor, innov: Tensor, r_diag: Tensor) -> UdState:
    """Vector observe as a sequence of Bierman scalar updates (valid for
    diagonal R; decorrelate first otherwise)."""
    H = torch.atleast_2d(H)
    innov = torch.atleast_1d(innov)
    r_diag = torch.atleast_1d(torch.as_tensor(r_diag, dtype=state.d.dtype, device=state.d.device))
    st = state
    for i in range(H.shape[0]):
        # Re-linearized innovation for sequential scalars: fold in the
        # state shift of the previous rows.
        shift = H[i] @ (st.mean - state.mean)
        st = bierman_update(st, H[i], innov[i] - shift, r_diag[i])
    return st
