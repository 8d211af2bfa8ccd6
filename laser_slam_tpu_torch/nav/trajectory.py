"""Velocity-profile trajectory generation (port of ``nav/trajectory.py``).

A waypoint path becomes fixed-rate wheel-velocity command schedules:
per-segment trapezoidal speed profiles with acceleration and
deceleration limits, cubic blending between segments, in-place spins,
emitted as ``CMD_SLICE`` = 0.05 s slices for the motor link. Each profile
is a closed-form function of time sampled onto a fixed-length slice grid
with a validity mask; corners blend as one batch.

Functions that take Python numbers or numpy arrays build their tensors
on ``device``: ``cuda`` unless the caller names another (``"cpu"`` asks
for the CPU); tensors keep their own device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.refmath import linspace01

Tensor = torch.Tensor

# Reference constants.
MAX_ACC = 0.8        # [m/s²]
MAX_DEC = 0.4        # [m/s²] magnitude
MAX_SPD = 0.7        # [m/s]
CMD_SLICE = 0.05     # [s] command slice length
MAX_SLICES = 512     # fixed schedule capacity (25.6 s per segment)


def _device(values, device) -> torch.device:
    for v in values:
        if isinstance(v, Tensor):
            return v.device
    return resolve_device(device)


def _f32(x, device) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


class Profile(NamedTuple):
    v: Tensor        # [MAX_SLICES] speed at each slice [m/s]
    valid: Tensor    # [MAX_SLICES] bool — slice is part of the segment
    v_end: Tensor    # [] achieved end speed (may undershoot the request
    #                  when the segment is too short)
    t_total: Tensor  # [] profile duration [s]


def trapezoid_profile(
    dist,
    v0,
    v_end,
    v_max: float = MAX_SPD,
    acc: float = MAX_ACC,
    dec: float = MAX_DEC,
    dt: float = CMD_SLICE,
    device=None,
) -> Profile:
    """Trapezoidal speed profile over a straight segment of ``dist`` m:
    clamp the requested end speed to what the distance allows, find the
    peak or cruise speed, and sample the accelerate / cruise / decelerate
    phases onto the slice grid."""
    dev = _device((dist, v0, v_end), device)
    dist, v0, v_end = (_f32(x, dev) for x in (dist, v0, v_end))

    # Reachable end-speed band over this distance.
    v_up = torch.sqrt(torch.clamp(v0 * v0 + 2.0 * acc * dist, min=0.0))
    v_dn = torch.sqrt(torch.clamp(v0 * v0 - 2.0 * dec * dist, min=0.0))
    ve = torch.minimum(torch.maximum(v_end, v_dn), v_up)

    # Peak speed of the accelerate-then-decelerate triangle, capped by
    # v_max into a cruise phase.
    v_peak_sq = (2.0 * acc * dec * dist + dec * v0 * v0 + acc * ve * ve) / (acc + dec)
    v_peak = torch.sqrt(torch.clamp(v_peak_sq, min=0.0))
    v_cruise = torch.clamp(v_peak, max=v_max)
    v_cruise = torch.maximum(v_cruise, torch.maximum(v0, ve))  # pure ramp cases

    t1 = (v_cruise - v0) / acc                       # accel duration
    t3 = (v_cruise - ve) / dec                       # decel duration
    s1 = (v_cruise * v_cruise - v0 * v0) / (2.0 * acc)
    s3 = (v_cruise * v_cruise - ve * ve) / (2.0 * dec)
    s2 = torch.clamp(dist - s1 - s3, min=0.0)
    t2 = torch.where(v_cruise > 1e-6, s2 / torch.clamp(v_cruise, min=1e-6), 0.0)
    t_total = t1 + t2 + t3

    t = (torch.arange(MAX_SLICES, dtype=torch.float32, device=dev) + 0.5) * dt
    v_t = torch.where(
        t < t1,
        v0 + acc * t,
        torch.where(t < t1 + t2, v_cruise,
                    torch.maximum(v_cruise - dec * (t - t1 - t2), ve)),
    )
    valid = t < t_total
    return Profile(v=torch.where(valid, v_t, 0.0), valid=valid, v_end=ve, t_total=t_total)


def spin_profile(
    angle,
    omega_max: float = 1.0,
    alpha: float = 2.0,
    dt: float = CMD_SLICE,
    device=None,
) -> Profile:
    """In-place turn schedule: a triangular / trapezoidal angular-rate
    profile through ``angle`` rad; ``v`` holds the SIGNED angular rate."""
    dev = _device((angle,), device)
    angle = _f32(angle, dev)
    a = torch.abs(angle)
    sgn = torch.sign(angle)
    w_peak = torch.clamp(torch.sqrt(alpha * a), max=omega_max)
    t1 = w_peak / alpha
    s1 = w_peak * w_peak / (2.0 * alpha)
    t2 = torch.where(w_peak > 1e-6,
                     torch.clamp(a - 2.0 * s1, min=0.0) / torch.clamp(w_peak, min=1e-6), 0.0)
    t_total = 2.0 * t1 + t2
    t = (torch.arange(MAX_SLICES, dtype=torch.float32, device=dev) + 0.5) * dt
    w = torch.where(
        t < t1,
        alpha * t,
        torch.where(t < t1 + t2, w_peak,
                    torch.clamp(w_peak - alpha * (t - t1 - t2), min=0.0)),
    )
    valid = t < t_total
    return Profile(v=torch.where(valid, sgn * w, 0.0), valid=valid,
                   v_end=torch.zeros((), device=dev), t_total=t_total)


def wheel_velocities(v, omega, wheel_base: float) -> tuple:
    """Differential-drive wheel speeds ``(vL, vR)`` from (v, ω)."""
    half = 0.5 * wheel_base
    return v - half * omega, v + half * omega


class BlendedCorner(NamedTuple):
    xy: Tensor       # [..., S, 2] sampled blended positions (world frame)
    ok: Tensor       # [...] bool — corner was blendable (non-degenerate)


def blend_corner(
    p0, p1, p2, n_slices: int = 100,
    blend_lo: float = 0.1, blend_hi: float = 0.9, device=None,
) -> BlendedCorner:
    """Cubic corner blend through waypoint triples ``(p0, p1, p2)`` of
    shape ``[..., 2]`` (any batch of corners): rotate into the chord frame
    (p0→p2 along x), follow the p0→p1 line to 10% of the chord, a cubic
    matching position and slope of both lines to 90%, then the p1→p2
    line, every slice at once.

    Degenerate corners (p0≈p2 U-turns, or a leg that does not advance
    along the chord) report ``ok=False``: the caller keeps the sharp
    corner."""
    dev = _device((p0, p1, p2), device)
    p0, p1, p2 = (_f32(p, dev) for p in (p0, p1, p2))
    chord = p2 - p0
    clen = torch.linalg.vector_norm(chord, dim=-1)
    theta = torch.atan2(chord[..., 1], chord[..., 0])
    c, s = torch.cos(-theta), torch.sin(-theta)

    d = p1 - p0
    q1 = torch.stack([c * d[..., 0] - s * d[..., 1], s * d[..., 0] + c * d[..., 1]], dim=-1)
    q2x, q2y = clen, torch.zeros_like(clen)

    # Line slopes in the chord frame (y as a function of x).
    dx1 = torch.clamp(torch.abs(q1[..., 0]), min=1e-6) * torch.sign(
        torch.where(q1[..., 0] == 0, 1.0, q1[..., 0]))
    dx2 = q2x - q1[..., 0]
    dx2 = torch.clamp(torch.abs(dx2), min=1e-6) * torch.sign(torch.where(dx2 == 0, 1.0, dx2))
    k1 = q1[..., 1] / dx1
    k2 = (q2y - q1[..., 1]) / dx2
    b2 = q1[..., 1] - k2 * q1[..., 0]

    xl = q2x
    x0 = blend_lo * xl
    y0 = k1 * x0
    x1 = blend_hi * xl
    y1 = k2 * x1 + b2
    xd = torch.clamp(x1 - x0, min=1e-6)
    # Cubic a0 + a1 t + a2 t² + a3 t³ over t = x - x0, matching value and
    # slope at both blend points.
    a0 = y0
    a1 = k1
    a2 = 3.0 * (y1 - y0) / xd ** 2 - (2.0 * k1 + k2) / xd
    a3 = -2.0 * (y1 - y0) / xd ** 3 + (k1 + k2) / xd ** 2

    e = lambda v: v[..., None]                                          # noqa: E731
    x = linspace01(n_slices, dev) * e(xl)
    t = x - e(x0)
    y = torch.where(
        x < e(x0),
        e(k1) * x,
        torch.where(x <= e(x1),
                    e(a0) + e(a1) * t + e(a2) * t * t + e(a3) * t ** 3,
                    e(k2) * x + e(b2)),
    )
    # Rotate back to world.
    cb, sb = e(torch.cos(theta)), e(torch.sin(theta))
    xy = torch.stack([e(p0[..., 0]) + cb * x - sb * y, e(p0[..., 1]) + sb * x + cb * y], dim=-1)
    # Blendable: chord long enough, both legs advance monotonically along
    # the chord (a backtracking leg means a U-turn).
    ok = (clen > 0.05) & (q1[..., 0] > 0.02) & (q2x - q1[..., 0] > 0.02)
    return BlendedCorner(xy=xy, ok=ok)


class WheelSchedule(NamedTuple):
    v_l: Tensor      # [S] left wheel speed per CMD_SLICE [m/s]
    v_r: Tensor      # [S] right wheel speed
    valid: Tensor    # [S]


def wheel_schedule_along(
    xy: np.ndarray,
    v_max: float = MAX_SPD,
    acc: float = MAX_ACC,
    dec: float = MAX_DEC,
    wheel_base: float = 0.5,
    dt: float = CMD_SLICE,
    max_slices: int = 4 * MAX_SLICES,
    device=None,
) -> WheelSchedule:
    """Open-loop differential wheel commands along a (blended) polyline:
    a trapezoidal speed profile over its arc length plus the curvature-
    induced ω at each slice."""
    dev = resolve_device(device)
    xy = np.asarray(xy, np.float32).reshape(-1, 2)
    seg = np.diff(xy, axis=0)
    seg_len = np.linalg.norm(seg, axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg_len)])
    total = float(arc[-1])
    heads = np.unwrap(np.arctan2(seg[:, 1], seg[:, 0]))

    prof = trapezoid_profile(total, 0.0, 0.0, v_max, acc, dec, dt, device=dev)
    v = prof.v.cpu().numpy()
    # Arc position at each slice midpoint → heading → ω = dθ/dt.
    s_at = np.cumsum(v * dt)
    idx = np.clip(np.searchsorted(arc, s_at) - 1, 0, len(heads) - 1)
    th = heads[idx]
    om = np.zeros_like(v)
    om[1:] = (th[1:] - th[:-1]) / dt
    om = np.clip(om, -2.0, 2.0)
    vl, vr = wheel_velocities(prof.v, torch.from_numpy(om).to(dev), wheel_base)
    n = min(len(v), max_slices)
    return WheelSchedule(v_l=vl[:n], v_r=vr[:n], valid=prof.valid[:n])


def blend_path(path: np.ndarray, n_slices: int = 40, device=None) -> np.ndarray:
    """Smooth a waypoint polyline by blending every interior corner (one
    batch of :func:`blend_corner`); unblendable corners stay sharp.
    Returns the densified polyline ``[M, 2]``."""
    path = np.asarray(path, np.float32).reshape(-1, 2)
    if len(path) < 3:
        return path
    dev = resolve_device(device)
    out = blend_corner(*(torch.from_numpy(np.ascontiguousarray(p)).to(dev)
                         for p in (path[:-2], path[1:-1], path[2:])), n_slices)
    xy, ok = out.xy.cpu().numpy(), out.ok.cpu().numpy()
    pts = [path[:1]]
    for i in range(len(ok)):
        if ok[i]:
            # The corner's middle half (the blend region); the straight
            # parts come from the neighbouring entries.
            pts.append(xy[i][n_slices // 4: 3 * n_slices // 4])
        else:
            pts.append(path[i + 1: i + 2])
    pts.append(path[-1:])
    return np.concatenate(pts, axis=0)


class Schedule(NamedTuple):
    v: Tensor         # [S, MAX_SLICES] per-segment speeds
    valid: Tensor     # [S, MAX_SLICES]
    seg_ok: Tensor    # [S] segment is real (not padding)
    headings: Tensor  # [S] segment headings [rad]


def plan_velocity_schedule(
    path: np.ndarray,
    speed_limits: np.ndarray | None = None,
    v_max: float = MAX_SPD,
    acc: float = MAX_ACC,
    dec: float = MAX_DEC,
    max_segments: int = 32,
    device=None,
) -> Schedule:
    """Whole-path schedule: chain trapezoids over the waypoint segments,
    carrying each achieved end speed into the next segment's start, with
    per-segment limits; the end speed at a corner scales with the turn
    angle (a U-turn stops) and the goal stops. The segments run one after
    the other on ``device``, each reading its end speed back."""
    dev = resolve_device(device)
    path = np.asarray(path, np.float32).reshape(-1, 2)
    n_seg = max(len(path) - 1, 0)
    if speed_limits is None:
        speed_limits = np.full(n_seg, v_max, np.float32)
    d = np.diff(path, axis=0)
    lens = np.linalg.norm(d, axis=1)
    heads = np.arctan2(d[:, 1], d[:, 0])
    # Corner end-speed: full speed through straight joints, zero at
    # U-turns (linear in the turn angle).
    turn = np.abs(
        (np.diff(heads, append=heads[-1:] if n_seg else 0.0) + np.pi)
        % (2 * np.pi) - np.pi
    )
    v_corner = np.clip(1.0 - turn / np.pi, 0.0, 1.0) * np.minimum(speed_limits, v_max)
    v_corner[-1:] = 0.0                       # stop at the goal

    vs = torch.zeros((max_segments, MAX_SLICES), device=dev)
    valids = torch.zeros((max_segments, MAX_SLICES), dtype=torch.bool, device=dev)
    seg_ok = np.zeros(max_segments, bool)
    headings = np.zeros(max_segments, np.float32)
    v0 = 0.0
    for i in range(min(n_seg, max_segments)):
        vm = float(min(speed_limits[i], v_max))
        p = trapezoid_profile(lens[i], v0, float(v_corner[i]), vm, acc, dec, device=dev)
        vs[i], valids[i] = p.v, p.valid
        seg_ok[i] = True
        headings[i] = heads[i]
        v0 = float(p.v_end)
    return Schedule(v=vs, valid=valids, seg_ok=torch.from_numpy(seg_ok).to(dev),
                    headings=torch.from_numpy(headings).to(dev))
