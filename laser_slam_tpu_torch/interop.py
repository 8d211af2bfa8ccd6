"""State carried between this port and ``laser_slam_tpu``.

The system has no weights; its state is the laser model, scans, poses,
grids, submaps, loop candidates and verified loops (with their quality),
the pose graph, the loop bank, the SLAM configuration, the filter and
particle states, the odometry carry, PL-ICP results, feature sets and
the incremental backend's persistent state. These
helpers move them through plain python / numpy, so neither package
imports the other. A whole online session crosses through its checkpoint
file: ``OnlineSlam.save`` of either package writes the keys that
``OnlineSlam.resume`` of the other reads. Index
arrays become ``int64`` tensors (what ``gather`` and indexing take) and
go back as ``int32``, the type the JAX package keeps them in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.scan import LaserModel, Scan
from .graph.loop_closure import LoopCandidates, VerifiedLoops
from .graph.solve import PoseGraph
from .graph.submap import Submaps
from .mapping.occupancy import GridSpec2D, OccupancyGrid
from .runtime.slam import SlamConfig


def model_from_fields(d: dict) -> LaserModel:
    """A port :class:`LaserModel` from the field dict of a JAX
    ``LaserModel`` (``dataclasses.asdict``)."""
    return LaserModel(**d)


def model_to_fields(model: LaserModel) -> dict:
    return dataclasses.asdict(model)


def scan_from_numpy(ranges, bad, seg, device=None) -> Scan:
    """A port :class:`Scan` (copied) from array-likes ``[..., N]``."""
    return Scan(
        ranges=torch.tensor(np.asarray(ranges, np.float32), device=device),
        bad=torch.tensor(np.asarray(bad, bool), device=device),
        seg=torch.tensor(np.asarray(seg, np.int32), device=device),
    )


def scan_to_numpy(scan: Scan) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return tuple(x.detach().cpu().numpy() for x in scan)


def grid_from_numpy(log_odds, spec_fields: dict, device=None) -> OccupancyGrid:
    """A port grid from log-odds ``[H, W]`` and the field dict of a
    ``GridSpec2D``."""
    return OccupancyGrid(
        log_odds=torch.tensor(np.asarray(log_odds, np.float32), device=device),
        spec=GridSpec2D(**spec_fields),
    )


def grid_to_numpy(grid: OccupancyGrid) -> tuple[np.ndarray, dict]:
    return grid.log_odds.detach().cpu().numpy(), dataclasses.asdict(grid.spec)


_INDEX_FIELDS = {"src", "dst", "i", "j", "anchor_idx", "kernel"}


def _tensor(name: str, value, device):
    if value is None or isinstance(value, dict):
        return None
    a = np.asarray(value)
    if name in _INDEX_FIELDS:
        return torch.tensor(a.astype(np.int64), device=device)
    return torch.tensor(a, device=device)


def _array(name: str, value):
    if value is None or isinstance(value, dict):
        return None
    a = value.detach().cpu().numpy()
    return a.astype(np.int32) if name in _INDEX_FIELDS else a


def state_from_numpy(cls, fields: dict, device=None):
    """A port ``Submaps``, ``LoopCandidates``, ``VerifiedLoops`` or
    ``PoseGraph`` from the field dict of its JAX namesake (``x._asdict()``
    with array values; a ``diag`` dict is dropped)."""
    if cls not in (Submaps, LoopCandidates, VerifiedLoops, PoseGraph):
        raise TypeError(f"state_from_numpy: {cls!r} is not a state tuple of the port")
    return cls(**{k: _tensor(k, v, device) for k, v in fields.items()})


def state_to_numpy(state) -> dict:
    """The field dict of a port state tuple, as numpy arrays."""
    return {k: _array(k, v) for k, v in state._asdict().items()}


def bank_from_numpy(bank: dict) -> dict:
    """A copy of a loop bank (the host-side dict of
    ``run_correlative_rounds``: ``src``, ``dst``, ``rel``, ``q``, ``act``,
    ``strict``, ``cov`` and, after a solve, ``used``) with the types the
    bookkeeping expects. Both packages keep the bank in numpy."""
    types = {"src": np.int32, "dst": np.int32, "rel": np.float32, "q": np.float32,
             "act": bool, "strict": bool, "cov": np.float32, "used": bool}
    return {k: np.array(v, dtype=types[k]) for k, v in bank.items()}


def config_from_fields(d: dict) -> SlamConfig:
    """A port :class:`SlamConfig` from the field dict of a JAX
    ``SlamConfig`` (``dataclasses.asdict``)."""
    return SlamConfig(**d)


def config_to_fields(cfg: SlamConfig) -> dict:
    return dataclasses.asdict(cfg)


def named_state_from_numpy(cls, fields: dict, device=None):
    """A port ``UkfState``, ``ParticleState``, odometry carry
    (``ops.odometry._OdoCarry``), ``PlIcpResult`` or ``FeatureSet`` from
    the field dict of its JAX namesake (``x._asdict()``; a carry's two
    scans as ``(ranges, bad, seg)`` tuples or ``Scan``s of arrays).
    Floating fields become float32; integer and boolean fields keep
    their type."""
    from .features.detector import FeatureSet
    from .fusion.ukf import UkfState
    from .localization.particle_filter import ParticleState
    from .ops.odometry import _OdoCarry
    from .ops.plicp import PlIcpResult

    if cls not in (UkfState, ParticleState, _OdoCarry, PlIcpResult, FeatureSet):
        raise TypeError(f"named_state_from_numpy: {cls!r} is not a named state of the port")

    def leaf(v):
        if isinstance(v, tuple):                       # a scan
            return scan_from_numpy(*v, device=device)
        a = np.asarray(v)
        return torch.tensor(a.astype(np.float32) if a.dtype.kind == "f" else a, device=device)

    return cls(**{k: leaf(v) for k, v in fields.items()})


def named_state_to_numpy(state) -> dict:
    """The field dict of a ``UkfState``, ``ParticleState``, odometry
    carry, ``PlIcpResult`` or ``FeatureSet`` as numpy arrays (a carry's
    scans as ``(ranges, bad, seg)``); as well of the navigation results:
    ``PlanResult``, ``Milestone``, ``ControlCommand``, the trajectory
    tuples (``Profile``, ``BlendedCorner``, ``WheelSchedule``,
    ``Schedule``) and ``BeaconFix``."""
    return {k: scan_to_numpy(v) if isinstance(v, Scan) else v.detach().cpu().numpy()
            for k, v in state._asdict().items()}


def local_map_from_numpy(log_odds, origin_cell, resolution: float, device=None):
    """A port ``LocalMap`` from its log-odds ``[H, W]``, the world cell
    ``(cx, cy)`` of its cell ``(0, 0)`` (exact, int32) and its
    resolution."""
    from .nav.local_map import LocalMap

    return LocalMap(
        log_odds=torch.tensor(np.asarray(log_odds, np.float32), device=device),
        origin_cell=torch.tensor(np.asarray(origin_cell).astype(np.int32), device=device),
        resolution=float(resolution),
    )


def local_map_to_numpy(lmap) -> tuple[np.ndarray, np.ndarray, float]:
    """``(log_odds, origin_cell, resolution)`` of a port ``LocalMap``."""
    return (lmap.log_odds.detach().cpu().numpy(),
            lmap.origin_cell.cpu().numpy().astype(np.int32), float(lmap.resolution))


def _backend_fields(group_pts, group_ok, bank, tried, n_loops) -> dict:
    """A copy of an incremental backend's persistent state, typed."""
    return {
        "group_pts": [np.array(x, np.float32) for x in group_pts],
        "group_ok": [np.array(x, bool) for x in group_ok],
        "bank": None if bank is None else bank_from_numpy(bank),
        "tried": None if tried is None else np.array(tried, bool),
        "n_loops": int(n_loops),
    }


def backend_state_to_numpy(backend) -> dict:
    """The persistent state of an ``IncrementalBackend`` of either
    package (their attributes have the same names): per-anchor group
    clouds and masks, the loop bank, the tried-pair matrix, the loop
    count. All of it lives on the host in numpy already; this copies it."""
    return _backend_fields(backend._group_pts, backend._group_ok, backend._bank,
                           backend._tried, backend.n_loops)


def backend_state_from_numpy(backend, state: dict) -> None:
    """Loads what :func:`backend_state_to_numpy` returned into an
    ``IncrementalBackend`` of either package, so that its next round
    continues the other's session."""
    fresh = _backend_fields(**state)
    backend._group_pts, backend._group_ok = fresh["group_pts"], fresh["group_ok"]
    backend._bank, backend._tried, backend.n_loops = fresh["bank"], fresh["tried"], fresh["n_loops"]
