"""RawSeed CSV log reader (``timestamp,num_points,offset,r1,...``) and the
whitespace SICK log reader (port of ``io/rawseed.py``; numpy)."""

from __future__ import annotations

import numpy as np

from ..core.scan import PRESETS, LaserModel


def read_rawseed(path: str, model: LaserModel | None = None, max_scans: int | None = None):
    """Returns ``(ranges [T, N] float32 meters, timestamps [T], model)``;
    the model is the preset with the log's beam count unless given."""
    rows, ts = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 4:
                continue
            n = int(parts[1])
            if model is None:
                for m in PRESETS.values():
                    if n == m.n_beams:
                        model = m
                        break
                if model is None:
                    raise ValueError(f"unknown beam count {n}")
            if n != model.n_beams:
                continue
            rows.append(np.asarray(parts[3: 3 + n], dtype=np.float32))
            ts.append(float(parts[0]))
            if max_scans is not None and len(rows) >= max_scans:
                break
    if not rows:
        raise ValueError(f"no scans read from {path}")
    ranges = np.stack(rows)
    ranges = np.where(ranges < model.min_range, model.max_range + 1.0, ranges).astype(np.float32)
    return ranges, np.asarray(ts), model


def read_sick_log(path: str, model: LaserModel | None = None, max_scans: int | None = None):
    """Whitespace SICK log: ``tag N r1..rN`` per line, meters; returns
    ``(ranges [T, N], model)``, short lines padded beyond the max range."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                continue
            n = int(float(parts[1]))
            if model is None:
                for m in PRESETS.values():
                    if n <= m.n_beams:
                        model = m
                        break
            n = min(n, model.n_beams)
            r = np.full(model.n_beams, model.max_range + 1.0, np.float32)
            r[:n] = np.asarray(parts[2: 2 + n], dtype=np.float32)
            rows.append(r)
            if max_scans is not None and len(rows) >= max_scans:
                break
    if not rows:
        raise ValueError(f"no scans read from {path}")
    ranges = np.stack(rows)
    ranges = np.where(ranges < model.min_range, model.max_range + 1.0, ranges).astype(np.float32)
    return ranges, model
