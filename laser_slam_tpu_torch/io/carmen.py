"""CARMEN log reader (numpy; a copy of ``laser_slam_tpu/io/carmen.py``).

Produces fixed-shape ``[T, N]`` range arrays plus ground-truth poses from
CARMEN-format logs (``ROBOTLASER1`` + ``VERTEX2`` records).

Format of a ROBOTLASER1 record:
``ROBOTLASER1 type start fov res maxR acc remission N r1..rN
num_remissions laser_x laser_y laser_th ... timestamp host logger_ts``
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core.scan import LaserModel, PRESETS, pad_beams


@dataclasses.dataclass
class CarmenLog:
    """A parsed CARMEN log: ranges ``[T, N]``, laser poses ``[T, 3]``,
    GT poses ``[G, 3]`` (VERTEX2), timestamps ``[T]`` and the
    :class:`LaserModel` adjusted from the log header."""

    ranges: np.ndarray       # [T, N] float32, meters
    laser_pose: np.ndarray   # [T, 3] float32 (x, y, theta) — pose in record
    gt_pose: np.ndarray      # [G, 3] float32 VERTEX2 ground truth
    timestamps: np.ndarray   # [T] float64
    model: LaserModel

    @property
    def n_scans(self) -> int:
        return self.ranges.shape[0]


def _pick_model(n_points: int) -> LaserModel:
    """Choose a preset by beam count, accepting N or N+1."""
    for m in PRESETS.values():
        if n_points in (m.n_beams, m.n_beams - 1):
            return m
    return LaserModel(f"GENERIC{n_points}", n_points, 180.0, -90.0, 50.0)


def read_carmen(path: str, tag: str = "ROBOTLASER1", max_scans: int | None = None) -> CarmenLog:
    """Parse a CARMEN log file.

    The first laser record overrides ``fi_min`` and ``max_range``; short
    readings (< min_range) are pushed past max_range; 180-beam logs are
    padded to the 181-beam model.
    """
    ranges_rows: list[np.ndarray] = []
    pose_rows: list[tuple[float, float, float]] = []
    ts_rows: list[float] = []
    gt_rows: list[tuple[float, float, float]] = []
    model: LaserModel | None = None

    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VERTEX2":
                gt_rows.append((float(parts[2]), float(parts[3]), float(parts[4])))
                continue
            if parts[0] != tag:
                continue
            start = float(parts[2])
            max_range = float(parts[5])
            n = int(parts[8])
            if n == 0:
                continue
            if model is None:
                model = _pick_model(n).with_start(start, max_range)
            r = np.array(parts[9 : 9 + n], dtype=np.float32)
            rest = parts[9 + n :]
            # rest = [num_remissions, (remissions...), laser_x, laser_y,
            #         laser_th, odo_x, odo_y, odo_th, tv, rv, fwd, side,
            #         axis, timestamp, host, logger_ts]
            n_rem = int(float(rest[0])) if rest else 0
            pose_fields = rest[1 + n_rem : 4 + n_rem]
            if len(pose_fields) == 3:
                pose_rows.append(tuple(float(v) for v in pose_fields))
            else:
                pose_rows.append((0.0, 0.0, 0.0))
            ts = 0.0
            if len(rest) >= 4 + n_rem + 9:
                try:
                    ts = float(rest[4 + n_rem + 8])
                except ValueError:
                    ts = 0.0
            ts_rows.append(ts)
            ranges_rows.append(r)
            if max_scans is not None and len(ranges_rows) >= max_scans:
                break

    if model is None or not ranges_rows:
        raise ValueError(f"no {tag} records found in {path}")

    raw = np.stack(ranges_rows)
    raw = np.where(raw < model.min_range, model.max_range + 1.0, raw)
    ranges = pad_beams(raw, model.n_beams, fill=model.max_range + 1.0)

    return CarmenLog(
        ranges=ranges.astype(np.float32),
        laser_pose=np.array(pose_rows, dtype=np.float32),
        gt_pose=np.array(gt_rows, dtype=np.float32).reshape(-1, 3),
        timestamps=np.array(ts_rows, dtype=np.float64),
        model=model,
    )
