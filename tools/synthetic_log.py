"""Synthetic CARMEN log generator (numpy only).

Ray-casts an 18 × 12 m multi-room floor plan (line segments: outer
walls, a wall with three doorways, two room partitions, a half
partition, pillars, furniture and an L-shaped block, so that no two
places look alike) from a robot that
drives a waypoint loop through the rooms. The log has intel-lab's shape:
``ROBOTLASER1`` records of 180 readings at 1° from -90° (the reader pads
them to the 181-beam LMS211 model), per-scan timestamps and ``VERTEX2``
ground truth.

- steps of at most 10 cm and 3°;
- range noise σ = 1 cm;
- ``n_whips`` sudden 90-100° rotations in place, each behind a 12× dt
  gap (the frame drops that force the odometry's exhaustive re-match).
  Whip angles sit on that re-match's 72-step rotation grid, so its peak
  is unambiguous and a run's ATE does not hinge on a near-tied score.

Usage::

    python tools/synthetic_log.py OUT.log [--scans 2672] [--seed 0]
"""

from __future__ import annotations

import argparse
import math

import numpy as np

N_READINGS = 180
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


def room_walls() -> np.ndarray:
    """An 8 × 8 m room (x ∈ [-3, 5], y ∈ [-4, 4]) with a pillar and an
    L-shaped block, so that no pose of it looks like another: the small
    scene of the port's parity tests."""
    w = _box(-3.0, -4.0, 5.0, 4.0)
    w += _box(1.8, 1.5, 2.4, 2.1)
    w += [(-2.2, -3.0, -0.8, -3.0), (-0.8, -3.0, -0.8, -2.2)]
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


def trajectory(n_scans: int, n_whips: int = 3, seed: int = 0):
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
                t += 12.0 * DT
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
                t += DT * (1.0 + 0.02 * rng.normal())
        th = math.remainder(th, 2 * math.pi)
        poses[i] = (x, y, th)
        ts[i] = t
    return poses, ts


def synthetic_log(n_scans: int = 2672, seed: int = 0, n_whips: int = 3):
    """``(ranges [T, 180], poses [T, 3], timestamps [T])``."""
    poses, ts = trajectory(n_scans, n_whips, seed)
    angles = START + RES * np.arange(N_READINGS)
    r = ray_cast(floor_plan(), poses, angles)
    rng = np.random.default_rng(seed + 1)
    r = np.where(r <= MAX_RANGE, r + rng.normal(0.0, NOISE, r.shape), r)
    return r.astype(np.float32), poses, ts


def write_carmen(path: str, ranges: np.ndarray, poses: np.ndarray, ts: np.ndarray) -> None:
    """Write ``ROBOTLASER1`` records (laser pose = GT pose) followed by
    ``VERTEX2`` ground truth, in the layout ``io/carmen.read_carmen``
    parses."""
    with open(path, "w") as f:
        for r, p, t in zip(ranges, poses, ts):
            vals = " ".join(f"{v:.4f}" for v in r)
            pose = f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}"
            f.write(
                f"ROBOTLASER1 0 {START:.9f} {math.pi:.9f} {RES:.9f} {MAX_RANGE:.1f} "
                f"0.01 0 {len(r)} {vals} 0 {pose} {pose} 0 0 0 0 0 "
                f"{t:.6f} synthetic {t:.6f}\n"
            )
        for i, p in enumerate(poses):
            f.write(f"VERTEX2 {i} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--scans", type=int, default=2672)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--whips", type=int, default=3)
    args = ap.parse_args(argv)
    write_carmen(args.out, *synthetic_log(args.scans, args.seed, args.whips))


if __name__ == "__main__":
    main()
