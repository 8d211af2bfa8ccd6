"""Landmark-SLAM filter schemes: EKF-SLAM and Rao-Blackwellized fastSLAM
(port of ``fusion/slam_schemes.py``).

- Fixed capacity: ``L_max`` landmark slots with a validity mask; a first
  sighting initializes its slot by a masked select, so every step has
  static shapes.
- A landmark index may be a device tensor: slots are read and written by
  index tensors, with no host read. Out of range it behaves as XLA's
  slices and gathers do: a negative start or index counts from the end
  once, a slice start is then clamped so that the slice fits, a read
  index is clamped, a write out of range is dropped.
- fastSLAM keeps ``[P]`` particles × ``[L]`` landmark EKFs as dense
  tensors with a leading particle axis.
- Random numbers come from a ``torch.Generator``; each sampling step has
  a deterministic half that takes the draws (``*_with_noise``, ``*_at``).
- The observation model is range-bearing
  ``z = (‖m − p‖, atan2(m − p) − θ)``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import se2

Tensor = torch.Tensor

_TWO_PI = 2.0 * math.pi


def _range_bearing(pose: Tensor, lm: Tensor) -> Tensor:
    """h(pose [..., 3], landmark [..., 2]) -> [..., 2] (range, bearing)."""
    d = lm - pose[..., :2]
    rng = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)
    brg = se2.normalize_angle(torch.atan2(d[..., 1], d[..., 0]) - pose[..., 2])
    return torch.stack([rng, brg], dim=-1)


def _noise2(r: Tensor | float, like: Tensor) -> Tensor:
    if isinstance(r, Tensor) and r.dim() > 0:
        return r.to(like.dtype)
    return torch.eye(2, dtype=like.dtype, device=like.device) * r


def _slot(lm_id, n: int, dev) -> tuple[Tensor, Tensor]:
    """``(read, write)`` for landmark ``lm_id`` of ``n`` slots: the index
    a gather reads (negative wraps once, then clamped) and the one-hot
    ``[n]`` mask a scatter writes (empty out of range)."""
    lm_id = torch.as_tensor(lm_id, dtype=torch.int64, device=dev)
    wrapped = torch.where(lm_id < 0, lm_id + n, lm_id)
    write = torch.arange(n, device=dev) == wrapped
    return wrapped.clamp(0, n - 1), write


# ---------------------------------------------------------------------------
# EKF-SLAM
# ---------------------------------------------------------------------------


class EkfSlamState(NamedTuple):
    """Joint Gaussian over [robot(3), landmarks(2·L_max)]."""

    mean: Tensor      # [3 + 2L]
    cov: Tensor       # [3 + 2L, 3 + 2L]
    lm_valid: Tensor  # [L] bool

    @property
    def n_landmarks(self) -> int:
        return self.lm_valid.shape[0]

    def robot(self) -> Tensor:
        return self.mean[:3]

    def landmarks(self) -> Tensor:
        return self.mean[3:].reshape(-1, 2)


def ekfslam_init(pose: Tensor, max_landmarks: int, pose_cov: float = 1e-4,
                 device=None) -> EkfSlamState:
    """The joint state on ``device`` (default: the device of ``pose``).
    Unseen landmark blocks get a huge prior variance; their first
    observation pins them."""
    pose = torch.as_tensor(pose, dtype=torch.float32)
    dev = pose.device if device is None else torch.device(device)
    d = 3 + 2 * max_landmarks
    mean = torch.zeros(d, dtype=torch.float32, device=dev)
    mean[:3] = pose.to(dev)
    cov = torch.eye(d, dtype=torch.float32, device=dev) * 1e6
    cov[:3, :3] = torch.eye(3, dtype=torch.float32, device=dev) * pose_cov
    return EkfSlamState(mean, cov, torch.zeros(max_landmarks, dtype=torch.bool, device=dev))


def ekfslam_predict(state: EkfSlamState, motion: Tensor, q: Tensor | float) -> EkfSlamState:
    """The robot moves by an SE(2) increment; landmarks are static (only
    the robot block and its cross-covariances change)."""
    pose = state.mean[:3]
    motion = motion.to(pose.dtype)
    new_pose = se2.compose(pose, motion)
    c, s = torch.cos(pose[2]), torch.sin(pose[2])
    mx, my = motion[0], motion[1]
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    Fr = torch.stack([
        torch.stack([one, zero, -s * mx - c * my]),
        torch.stack([zero, one, c * mx - s * my]),
        torch.stack([zero, zero, one]),
    ])
    if isinstance(q, Tensor) and q.dim() > 0:
        Q = q.to(pose.dtype)
    else:
        Q = torch.eye(3, dtype=pose.dtype, device=pose.device) * q
    mean = torch.cat([new_pose, state.mean[3:]])
    Prm = Fr @ state.cov[:3, 3:]
    cov = state.cov.clone()
    cov[:3, :3] = Fr @ state.cov[:3, :3] @ Fr.T + Q
    cov[:3, 3:] = Prm
    cov[3:, :3] = Prm.T
    return EkfSlamState(mean, cov, state.lm_valid)


def ekfslam_observe(state: EkfSlamState, lm_id, z: Tensor, r: Tensor | float) -> EkfSlamState:
    """Observe landmark ``lm_id`` (an int or a device tensor) as (range,
    bearing).

    The first sighting initializes the landmark block from the inverse
    observation; later sightings run a joint EKF update. Both paths are
    computed and selected by mask, with no host read of ``lm_id``.
    """
    mean, cov = state.mean, state.cov
    dev, dt = mean.device, mean.dtype
    z = z.to(dt)
    R = _noise2(r, mean)
    L = state.n_landmarks
    D = 3 + 2 * L
    read, write = _slot(lm_id, L, dev)
    seen = state.lm_valid[read]
    # The block's rows: a negative slice start counts from the end once,
    # then the start is clamped so that the slice fits.
    sl = 3 + 2 * torch.as_tensor(lm_id, dtype=torch.int64, device=dev)
    sl = torch.where(sl < 0, sl + D, sl).clamp(0, D - 2)
    rows = sl + torch.arange(2, device=dev)
    pose = mean[:3]

    # --- init path: pin the landmark block at the inverse observation
    a = pose[2] + z[1]
    ca, sa = torch.cos(a), torch.sin(a)
    lm0 = pose[:2] + z[0] * torch.stack([ca, sa])          # the inverse observation
    zc, nzs = z[0] * ca, -(z[0] * sa)
    one, zero = torch.ones_like(ca), torch.zeros_like(ca)
    # Jacobians of the inverse observation wrt the pose and z.
    Gp = torch.stack([one, zero, nzs, zero, one, zc]).view(2, 3)
    Gz = torch.stack([ca, nzs, sa, zc]).view(2, 2)
    Pll = Gp @ cov[:3, :3] @ Gp.T + Gz @ R @ Gz.T
    Plx = Gp @ cov[:3, :]                                   # cross-cov with the whole state
    init_mean = mean.index_copy(0, rows, lm0)
    init_cov = cov.index_copy(0, rows, Plx)
    init_cov = init_cov.index_copy(1, rows, Plx.T)
    init_cov = init_cov.index_put((rows[:, None], rows[None, :]), Pll)

    # --- update path: joint EKF observe with sparse H = [Hr 0 .. Hl .. 0]
    lm = mean[rows]
    dxy = lm - pose[:2]
    q2 = torch.sum(dxy * dxy) + 1e-12
    u, v = dxy / torch.sqrt(q2), dxy / q2
    nu, nv = -u, -v
    Hr = torch.stack([nu[0], nu[1], zero, v[1], nv[0], -one]).view(2, 3)
    Hl = torch.stack([u[0], u[1], nv[1], v[0]]).view(2, 2)
    H = torch.cat([Hr, torch.zeros(2, D - 3, dtype=dt, device=dev)], dim=1).index_copy(1, rows, Hl)
    innov = z - _range_bearing(pose, lm)
    innov = torch.stack([innov[0], se2.normalize_angle(innov[1])])
    HP = H @ cov
    S = HP @ H.T + R
    K = torch.linalg.solve_ex(S, HP)[0].T
    upd_mean = mean + K @ innov
    ikh = torch.eye(D, dtype=dt, device=dev) - K @ H
    upd_cov = ikh @ cov @ ikh.T + K @ R @ K.T

    return EkfSlamState(
        torch.where(seen, upd_mean, init_mean),
        torch.where(seen, upd_cov, init_cov),
        state.lm_valid | write,
    )


# ---------------------------------------------------------------------------
# fastSLAM: Rao-Blackwellized particle filter
# ---------------------------------------------------------------------------


class FastSlamState(NamedTuple):
    poses: Tensor     # [P, 3] particle robot poses
    log_w: Tensor     # [P] log weights
    lm_mean: Tensor   # [P, L, 2] per-particle landmark EKF means
    lm_cov: Tensor    # [P, L, 2, 2]
    lm_valid: Tensor  # [P, L] bool

    @property
    def n_particles(self) -> int:
        return self.poses.shape[0]


def fastslam_init(pose: Tensor, n_particles: int, max_landmarks: int,
                  device=None) -> FastSlamState:
    """``n_particles`` copies of ``pose`` with empty maps, on ``device``
    (default: the device of ``pose``)."""
    pose = torch.as_tensor(pose, dtype=torch.float32)
    dev = pose.device if device is None else torch.device(device)
    p, lm = n_particles, max_landmarks
    eye = torch.eye(2, dtype=torch.float32, device=dev)
    return FastSlamState(
        poses=pose.to(dev)[None, :].repeat(p, 1),
        log_w=torch.zeros(p, dtype=torch.float32, device=dev),
        lm_mean=torch.zeros(p, lm, 2, dtype=torch.float32, device=dev),
        lm_cov=(eye * 1e6).expand(p, lm, 2, 2).clone(),
        lm_valid=torch.zeros(p, lm, dtype=torch.bool, device=dev),
    )


def fastslam_predict_with_noise(state: FastSlamState, motion: Tensor, sigma: Tensor,
                                noise: Tensor) -> FastSlamState:
    """The deterministic half of :func:`fastslam_predict`: each particle
    moves by ``motion + noise·sigma`` for standard-normal ``noise [P, 3]``."""
    like = state.poses
    noise = noise.to(like.device, like.dtype) * torch.as_tensor(sigma, dtype=like.dtype,
                                                                device=like.device)
    return state._replace(poses=se2.compose(state.poses, motion.to(like.device, like.dtype) + noise))


def fastslam_predict(state: FastSlamState, generator: torch.Generator, motion: Tensor,
                     sigma: Tensor) -> FastSlamState:
    """Sample each particle's pose through the noisy motion model (the
    particle half of the Rao-Blackwellization). The draws come from
    ``generator`` on its own device."""
    noise = torch.randn(state.poses.shape, generator=generator, device=generator.device)
    return fastslam_predict_with_noise(state, motion, sigma, noise)


def _particle_observe(pose, lm_mean, lm_cov, valid, z, R):
    """Every particle × its landmark: EKF observe (``[P, ...]``); returns
    the updated landmark and each particle's log-likelihood."""
    # init path
    a = pose[:, 2] + z[1]
    ca, sa = torch.cos(a), torch.sin(a)
    lm0 = pose[:, :2] + z[0] * torch.stack([ca, sa], dim=-1)     # the inverse observation
    zc = z[0] * ca
    Gz = torch.stack([ca, -(z[0] * sa), sa, zc], dim=-1).view(-1, 2, 2)
    cov0 = Gz @ R @ Gz.transpose(-1, -2)
    # update path
    zhat = _range_bearing(pose, lm_mean)
    dxy = lm_mean - pose[:, :2]
    q2 = torch.sum(dxy * dxy, dim=-1, keepdim=True) + 1e-12
    u, v = dxy / torch.sqrt(q2), dxy / q2
    Hl = torch.stack([u[:, 0], u[:, 1], -v[:, 1], v[:, 0]], dim=-1).view(-1, 2, 2)
    innov = z - zhat
    innov = torch.stack([innov[:, 0], se2.normalize_angle(innov[:, 1])], dim=-1)
    HlT = Hl.transpose(-1, -2)
    S = Hl @ lm_cov @ HlT + R
    Sinv = torch.linalg.inv_ex(S)[0]
    K = lm_cov @ HlT @ Sinv
    upd_mean = lm_mean + (K @ innov[..., None])[..., 0]
    upd_cov = (torch.eye(2, dtype=S.dtype, device=S.device) - K @ Hl) @ lm_cov
    maha = (innov[:, None, :] @ Sinv @ innov[..., None])[:, 0, 0]
    loglik = -0.5 * (maha + torch.log(torch.linalg.det(S)) + 2 * math.log(_TWO_PI))
    new_mean = torch.where(valid[:, None], upd_mean, lm0)
    new_cov = torch.where(valid[:, None, None], upd_cov, cov0)
    # Unseen landmarks contribute a constant (importance weight 1).
    return new_mean, new_cov, torch.where(valid, loglik, 0.0)


def fastslam_observe(state: FastSlamState, lm_id, z: Tensor, r: Tensor | float) -> FastSlamState:
    """All particles observe landmark ``lm_id`` (an int or a device
    tensor); the weights multiply by each particle's innovation
    likelihood."""
    dev, dt = state.poses.device, state.poses.dtype
    z = z.to(dev, dt)
    R = _noise2(r, state.poses)
    read, write = _slot(lm_id, state.lm_valid.shape[1], dev)
    m = state.lm_mean[:, read]
    c = state.lm_cov[:, read]
    v = state.lm_valid[:, read]
    nm, nc, ll = _particle_observe(state.poses, m, c, v, z, R)
    return FastSlamState(
        state.poses,
        state.log_w + ll,
        torch.where(write[None, :, None], nm[:, None, :], state.lm_mean),
        torch.where(write[None, :, None, None], nc[:, None], state.lm_cov),
        state.lm_valid | write[None, :],
    )


def fastslam_resample_at(state: FastSlamState, u0: Tensor | float) -> FastSlamState:
    """The deterministic half of :func:`fastslam_resample`: systematic
    resampling from one uniform draw ``u0`` in ``[0, 1/P)``."""
    p = state.n_particles
    w = torch.softmax(state.log_w, dim=0)
    cdf = torch.cumsum(w, dim=0)
    pts = u0 + torch.arange(p, device=w.device) / p
    idx = torch.searchsorted(cdf, pts.to(cdf.dtype)).clamp(0, p - 1)
    return FastSlamState(
        poses=state.poses[idx],
        log_w=torch.zeros_like(state.log_w),
        lm_mean=state.lm_mean[idx],
        lm_cov=state.lm_cov[idx],
        lm_valid=state.lm_valid[idx],
    )


def fastslam_resample(state: FastSlamState, generator: torch.Generator) -> FastSlamState:
    """Systematic resampling of the whole particle block (poses and
    landmark maps together: the map rides with its particle)."""
    u0 = torch.rand((), generator=generator, device=generator.device) / state.n_particles
    return fastslam_resample_at(state, u0.to(state.poses.device))


def fastslam_neff(state: FastSlamState) -> Tensor:
    w = torch.softmax(state.log_w, dim=0)
    return 1.0 / torch.sum(w * w)


def fastslam_estimate(state: FastSlamState) -> tuple[Tensor, Tensor]:
    """Weighted mean pose and the best particle's landmark map."""
    w = torch.softmax(state.log_w, dim=0)
    xy = torch.sum(w[:, None] * state.poses[:, :2], dim=0)
    th = torch.atan2(torch.sum(w * torch.sin(state.poses[:, 2])),
                     torch.sum(w * torch.cos(state.poses[:, 2])))
    best = torch.argmax(state.log_w)
    return torch.cat([xy, th[None]]), state.lm_mean[best]
