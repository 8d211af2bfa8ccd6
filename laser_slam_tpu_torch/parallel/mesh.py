"""Device-mesh helpers for multi-device execution (port of
``parallel/mesh.py``).

A mesh is a one-dimensional ``torch.distributed.device_mesh.DeviceMesh``
named ``"data"`` over the ranks of the default process group, one device
a rank. Scan batches and graph edges are split over it by rank; results
come back with collectives (``all_gather_into_tensor``, ``all_reduce``).
Where no process group exists, :func:`make_mesh` starts a one-process
group on an in-memory ``HashStore`` (no port is bound): ``nccl`` for
``cuda``, ``gloo`` for ``device="cpu"``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from ..core.device import resolve_device

DATA_AXIS = "data"


class Sharding(NamedTuple):
    """How a tensor lies over a mesh: its mesh and DTensor placements."""

    mesh: DeviceMesh
    placements: tuple


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def device_type_of_group() -> str:
    """``cuda`` for an ``nccl`` default group, ``cpu`` otherwise."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def local_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device of ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def make_mesh(n_devices: int | None = None, device=None) -> DeviceMesh:
    """1D data-parallel mesh over the ranks of the default process group.

    Without a process group, starts a one-process group for ``device``
    (default ``cuda``; raises where there is none). ``n_devices`` must be
    the group's size when given: a rank outside the mesh has no part in
    its collectives.
    """
    if not dist.is_initialized():
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index if dev.index is not None else 0)
        dist.init_process_group(backend_for(dev), store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the process group has {world}")
    return DeviceMesh(device_type_of_group(), list(range(world)), mesh_dim_names=(DATA_AXIS,))


def batch_sharding(mesh: DeviceMesh) -> Sharding:
    """Shard the leading (batch) axis across the mesh."""
    return Sharding(mesh, (Shard(0),))


def replicated(mesh: DeviceMesh) -> Sharding:
    return Sharding(mesh, (Replicate(),))


def rank_and_size(mesh: DeviceMesh) -> tuple[int, int]:
    """This process's rank in ``mesh`` and the mesh's size."""
    group = mesh.get_group()
    return dist.get_rank(group), dist.get_world_size(group)


def tree_map(fn, tree):
    """``fn`` over the tensors or arrays of a nest of (named) tuples,
    lists and dicts; ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def rows_of_rank(n: int, rank: int, size: int) -> slice:
    """This rank's rows of a leading axis of ``n`` (a multiple of ``size``)."""
    if n % size:
        raise ValueError(f"{n} rows do not split over {size} ranks (use pad_to_multiple)")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def shard_batch(mesh: DeviceMesh, tree):
    """This rank's rows of every leaf of ``tree`` (leading axis split over
    the mesh in rank order), on this rank's device."""
    rank, size = rank_and_size(mesh)
    dev = local_device(mesh)
    return tree_map(lambda x: x[rows_of_rank(x.shape[0], rank, size)].to(dev), tree)


def pad_to_multiple(tree, multiple: int, axis: int = 0):
    """Pad the leading axis to a multiple (shardable size) by repeating
    the last entry; returns ``(padded_tree, original_length)``."""
    lengths = {np.shape(x)[axis] for x in tree_leaves(tree)}
    (n,) = lengths
    pad = (-n) % multiple
    if pad == 0:
        return tree, n

    def _pad(x):
        widths = [(0, 0)] * np.ndim(x)
        widths[axis] = (0, pad)
        return np.pad(np.asarray(x), widths, mode="edge")

    return tree_map(_pad, tree), n
