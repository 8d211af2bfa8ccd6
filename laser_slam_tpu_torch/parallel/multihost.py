"""Multi-host execution entry point (port of ``parallel/multihost.py``).

Every host runs the same program; :func:`initialize` joins the processes
into one ``torch.distributed`` process group and :func:`global_mesh`
spans all of them, one device a rank. Collectives go over NCCL between
cards, over gloo between CPU processes.

Usage (same script on every host)::

    from laser_slam_tpu_torch.parallel.multihost import initialize, global_mesh

    initialize(coordinator="10.0.0.1:8476", num_processes=2,
               process_id=int(os.environ["HOST_ID"]))
    mesh = global_mesh()
    # ... shard loop-verification batches / the graph solve over it

With no arguments, ``initialize()`` reads the launcher's environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.device import resolve_device
from .mesh import DATA_AXIS, backend_for, device_type_of_group


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> None:
    """Join this process into a process group (idempotent): over
    ``tcp://coordinator`` when given, else the environment. ``nccl`` for
    ``device`` ``cuda`` (the default; each rank takes card ``process_id``
    modulo the host's cards), ``gloo`` for ``"cpu"``."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device((process_id or 0) % torch.cuda.device_count())
    dist.init_process_group(
        backend_for(dev),
        init_method="env://" if coordinator is None else f"tcp://{coordinator}",
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )


def global_mesh() -> DeviceMesh:
    """1D data mesh over every rank of every participating host."""
    return DeviceMesh(device_type_of_group(), list(range(dist.get_world_size())),
                      mesh_dim_names=(DATA_AXIS,))


def is_primary() -> bool:
    """True on the process that should do host-side orchestration / IO
    (rank 0, or a process without a group)."""
    return not dist.is_initialized() or dist.get_rank() == 0
