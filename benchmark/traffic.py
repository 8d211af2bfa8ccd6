"""The benchmark's traffic generator: synthetic CARMEN-shaped logs from a
seed, in the shape a configuration file states.

A frozen copy of the repository's ``tools/synthetic_log.py`` (numpy
only), with the sensor's reading count, angular resolution, scan period
and range noise as parameters; at 180 readings and 1° it returns the
tool's arrays bit for bit. It ray-casts an 18 × 12 m multi-room floor
plan from a robot that drives a waypoint loop through the rooms:

- steps of at most 10 cm and 3°;
- range noise σ (1 cm in both configurations);
- ``n_whips`` sudden 90-100° rotations in place, each behind a 12× dt
  gap (the frame drops that force the odometry's exhaustive re-match).
  Whip angles sit on that re-match's 72-step rotation grid.

:func:`make_log` turns a configuration into the log the program is fed:
ranges padded to the sensor preset's beam count, ground truth and
timestamps.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

START = -math.pi / 2
RES = math.pi / 180
MAX_RANGE = 50.0
DT = 0.1            # [s] median scan period
NOISE = 0.01        # [m] range noise σ
STEP = 0.07         # [m] cruise step
MAX_STEP = 0.10     # [m]
MAX_TURN = math.radians(3.0)


def _box(x0, y0, x1, y1):
    return [(x0, y0, x1, y0), (x1, y0, x1, y1), (x1, y1, x0, y1), (x0, y1, x0, y0)]


def floor_plan() -> np.ndarray:
    """``[S, 4]`` wall segments ``(x0, y0, x1, y1)`` in meters."""
    w = _box(0.0, 0.0, 18.0, 12.0)
    # Wall at y = 7.5 with doorways at x ∈ [2.8, 4.2], [8.3, 9.7], [13.8, 15.2].
    for a, b in ((0.0, 2.8), (4.2, 8.3), (9.7, 13.8), (15.2, 18.0)):
        w.append((a, 7.5, b, 7.5))
    w += [(6.0, 7.5, 6.0, 12.0), (12.0, 7.5, 12.0, 12.0)]    # three rooms
    w.append((9.0, 0.0, 9.0, 3.2))                           # half partition
    w += _box(4.8, 1.5, 5.3, 2.0) + _box(11.6, 1.6, 12.2, 2.2)  # pillars
    w += _box(0.6, 5.0, 1.2, 6.2) + _box(16.8, 4.0, 17.4, 5.2)  # hall clutter
    w += _box(15.6, 0.8, 16.8, 1.4)                          # cabinet
    w += [(1.2, 10.8, 2.4, 10.8), (2.4, 10.8, 2.4, 9.6)]     # L in room 1
    w += [(10.0, 11.2, 11.0, 11.2)]                          # shelf in room 2
    w += _box(16.5, 10.8, 17.3, 11.4)                        # table in room 3
    return np.asarray(w, dtype=np.float64)


WAYPOINTS = np.asarray([
    (2.5, 2.2), (6.8, 5.6), (9.0, 6.2), (9.0, 8.3), (9.5, 9.8),
    (9.0, 8.3), (9.0, 6.0), (14.5, 6.0), (14.5, 8.3), (15.0, 10.0),
    (14.5, 8.3), (14.5, 6.0), (15.0, 2.8), (10.8, 5.2), (6.0, 5.6),
    (3.5, 6.0), (3.5, 8.3), (4.2, 9.8), (3.5, 8.3), (3.5, 6.0),
])

# The ±π correlative re-match searches 72 rotations, linspace(-π, π, 72);
# whips turn by one of those between 90° and 100° either way (a 180° FOV
# keeps less than half its view across a larger whip).
_GRID = -math.pi + 2.0 * math.pi / 71.0 * np.arange(72)
WHIP_ANGLES = _GRID[(np.abs(_GRID) >= math.radians(90.0)) & (np.abs(_GRID) <= math.radians(100.0))]


def ray_cast(walls: np.ndarray, poses: np.ndarray, angles: np.ndarray,
             max_range: float = MAX_RANGE) -> np.ndarray:
    """Ranges ``[T, B]`` from sensor poses ``[T, 3]`` along bearings
    ``[B]`` (sensor frame) to the nearest wall; ``max_range + 1`` when
    nothing is hit."""
    out = np.empty((poses.shape[0], angles.shape[0]))
    q = walls[:, :2]
    e = walls[:, 2:] - walls[:, :2]                       # [S, 2]
    for i0 in range(0, poses.shape[0], 256):
        p = poses[i0:i0 + 256]
        a = p[:, 2:3] + angles[None, :]                   # [C, B]
        d = np.stack([np.cos(a), np.sin(a)], axis=-1)     # [C, B, 2]
        qp = q[None, :, :] - p[:, None, :2]               # [C, S, 2]
        den = d[..., None, 0] * e[:, 1] - d[..., None, 1] * e[:, 0]         # [C, B, S]
        tn = qp[:, None, :, 0] * e[:, 1] - qp[:, None, :, 1] * e[:, 0]
        un = qp[:, None, :, 0] * d[..., None, 1] - qp[:, None, :, 1] * d[..., None, 0]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = tn / den
            u = un / den
        hit = (np.abs(den) > 1e-12) & (t > 0) & (u >= 0) & (u <= 1)
        r = np.where(hit, t, np.inf).min(axis=-1)
        out[i0:i0 + 256] = np.where(np.isfinite(r) & (r <= max_range), r, max_range + 1.0)
    return out


def clearance(walls: np.ndarray, x: float, y: float) -> float:
    """Distance from ``(x, y)`` to the nearest wall segment."""
    q, e = walls[:, :2], walls[:, 2:] - walls[:, :2]
    u = np.clip(((x - q[:, 0]) * e[:, 0] + (y - q[:, 1]) * e[:, 1])
                / np.sum(e * e, axis=1), 0.0, 1.0)
    return float(np.min(np.hypot(q[:, 0] + u * e[:, 0] - x, q[:, 1] + u * e[:, 1] - y)))


def trajectory(n_scans: int, n_whips: int = 3, seed: int = 0, dt: float = DT):
    """Ground-truth poses ``[T, 3]`` and timestamps ``[T]`` of a robot
    following the waypoint loop, with ``n_whips`` frame-drop whips (each
    at the first pose past its evenly spaced slot with 1 m clearance;
    the robot then turns in place until it faces its waypoint)."""
    rng = np.random.default_rng(seed)
    walls = floor_plan()
    whip_slots = list(np.linspace(0, n_scans, n_whips + 2)[1:-1].round().astype(int))
    poses = np.zeros((n_scans, 3))
    ts = np.zeros(n_scans)
    x, y = WAYPOINTS[0]
    th = math.atan2(WAYPOINTS[1][1] - y, WAYPOINTS[1][0] - x)
    wp, t = 1, 0.0
    for i in range(n_scans):
        if i:
            if whip_slots and i >= whip_slots[0] and clearance(walls, x, y) > 1.0:
                whip_slots.pop(0)
                th += rng.choice(WHIP_ANGLES)
                t += 12.0 * dt
            else:
                gx, gy = WAYPOINTS[wp]
                if math.hypot(gx - x, gy - y) < 0.3:
                    wp = (wp + 1) % len(WAYPOINTS)
                    gx, gy = WAYPOINTS[wp]
                err = math.remainder(math.atan2(gy - y, gx - x) - th, 2 * math.pi)
                dth = float(np.clip(err, -MAX_TURN, MAX_TURN))
                dth += rng.normal(0.0, 0.002)
                v = STEP * max(0.0, math.cos(err)) ** 2 * (1.0 + 0.2 * rng.normal())
                v = float(np.clip(v, 0.0, MAX_STEP))
                th += dth
                x += v * math.cos(th)
                y += v * math.sin(th)
                t += dt * (1.0 + 0.02 * rng.normal())
        th = math.remainder(th, 2 * math.pi)
        poses[i] = (x, y, th)
        ts[i] = t
    return poses, ts


def synthetic_log(n_scans: int = 2672, seed: int = 0, n_whips: int = 3,
                  n_readings: int = 180, res: float = RES, dt: float = DT,
                  noise: float = NOISE, trajectory_seed: int | None = None):
    """``(ranges [T, n_readings], poses [T, 3], timestamps [T])``: readings
    ``res`` apart from -90°. The path and the timestamps come from
    ``trajectory_seed`` (default ``seed``), the range noise from ``seed``."""
    poses, ts = trajectory(n_scans, n_whips, seed if trajectory_seed is None else trajectory_seed,
                           dt)
    angles = START + res * np.arange(n_readings)
    r = ray_cast(floor_plan(), poses, angles)
    rng = np.random.default_rng(seed + 1)
    r = np.where(r <= MAX_RANGE, r + rng.normal(0.0, noise, r.shape), r)
    return r.astype(np.float32), poses, ts


@dataclasses.dataclass(frozen=True)
class Log:
    """A generated log as the program is fed it."""

    ranges: np.ndarray       # [T, N] float32, padded to the preset's beams
    gt: np.ndarray           # [T, 3] float32 ground-truth poses
    timestamps: np.ndarray   # [T] float64 seconds
    n_beams: int
    start_rad: float
    max_range: float
    min_range: float


def make_log(cfg: dict, seed: int, n_scans: int | None = None,
             trajectory_seed: int | None = None) -> Log:
    """The log of configuration ``cfg`` from ``seed``; with
    ``trajectory_seed`` every seed drives the same path at the same
    times and draws only its own range noise. As the CARMEN reader does, a
    reading below the sensor's minimum range is pushed past its maximum
    and the readings are padded to the preset's beam count with
    ``max_range + 1``. ``n_scans`` shortens the log (tests)."""
    s = cfg["sensor"]
    raw, poses, ts = synthetic_log(
        n_scans or cfg["n_scans"], seed, cfg["n_whips"], s["readings"],
        math.radians(s["resolution_deg"]), cfg["scan_period_s"], cfg["range_noise_m"],
        trajectory_seed)
    far = np.float32(s["max_range_m"] + 1.0)
    raw = np.where(raw < s["min_range_m"], far, raw)
    ranges = np.full((raw.shape[0], s["beams"]), far, np.float32)
    ranges[:, :raw.shape[1]] = raw
    return Log(ranges, poses.astype(np.float32), ts, s["beams"], math.radians(s["start_deg"]),
               float(s["max_range_m"]), float(s["min_range_m"]))

