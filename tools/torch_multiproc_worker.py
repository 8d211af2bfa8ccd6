"""Worker for the multi-process ``torch.distributed`` test of the PyTorch
port: each process joins one process group (gloo on the CPU by default)
and runs the distributed SLAM backend step, ``parallel.distributed.
training_step`` (sharded PSM matching feeding the edge-sharded pose-graph
solve), over ``2 × world`` pairs.

The pairs and the graph follow the JAX package's dry run: the same
rectangular room seen from a random base pose and a small known offset,
from the same ``numpy.random.default_rng(0)`` sequence, preprocessed by
the port; a chain of ``B + 4`` poses whose first ``B`` edges are the loop
edges the matches refresh.

Usage: python tools/torch_multiproc_worker.py <coordinator> <nprocs> <pid> [device]

``coordinator`` is ``host:port``; ``device`` is ``cpu`` (the default,
gloo) or ``cuda``. Prints ``MULTIPROC_OK pid=… chi2=… fails=…``.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def box_ranges(model, pose, box=(-3.0, 5.0, -4.0, 4.0)):
    """Analytic ranges of a rectangular room seen from ``pose`` [3]."""
    n = model.n_beams
    fi = np.arange(n) * model.dfi + model.fi_min + pose[2]
    dx, dy = np.cos(fi), np.sin(fi)
    x0, x1, y0, y1 = box
    ts = np.full((4, n), np.inf, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for k, t in enumerate(
            [(x0 - pose[0]) / dx, (x1 - pose[0]) / dx,
             (y0 - pose[1]) / dy, (y1 - pose[1]) / dy]
        ):
            hit_y = pose[1] + t * dy if k < 2 else pose[0] + t * dx
            lo, hi = (y0, y1) if k < 2 else (x0, x1)
            ok = (t > 0) & (hit_y >= lo) & (hit_y <= hi)
            ts[k] = np.where(ok, t, np.inf)
    return ts.min(axis=0).astype(np.float32)


def synthetic_pair_ranges(model, batch, seed=0):
    """Raw ranges ``(ref [B, N], cur [B, N])`` of matched pairs and their
    true relative poses ``[B, 3]``: the same room seen from a base pose
    and from a small known offset."""
    rng = np.random.default_rng(seed)
    ref = np.empty((batch, model.n_beams), np.float32)
    cur = np.empty((batch, model.n_beams), np.float32)
    true_rel = np.empty((batch, 3), np.float32)
    for b in range(batch):
        base = np.array(
            [rng.uniform(-1, 2), rng.uniform(-1.5, 1.5), rng.uniform(-np.pi, np.pi)], np.float32
        )
        off = np.array(
            [rng.uniform(-0.15, 0.15), rng.uniform(-0.15, 0.15), rng.uniform(-0.08, 0.08)],
            np.float32,
        )
        c, s = np.cos(base[2]), np.sin(base[2])
        moved = np.array(
            [base[0] + c * off[0] - s * off[1], base[1] + s * off[0] + c * off[1],
             base[2] + off[2]], np.float32
        )
        ref[b] = box_ranges(model, base) + rng.normal(0, 0.005, model.n_beams)
        cur[b] = box_ranges(model, moved) + rng.normal(0, 0.005, model.n_beams)
        true_rel[b] = off
    return ref, cur, true_rel


def synthetic_pairs(model, batch, seed=0, device="cpu"):
    """Preprocessed pairs ``(ref, cur)`` on ``device`` and the true
    relative poses."""
    import torch

    from laser_slam_tpu_torch.ops.preprocess import preprocess

    ref, cur, true_rel = synthetic_pair_ranges(model, batch, seed)
    return (preprocess(torch.as_tensor(ref, device=device), model),
            preprocess(torch.as_tensor(cur, device=device), model), true_rel)


def dryrun_graph(b, device="cpu"):
    """The dry run's pose graph for ``b`` loop candidates: a chain of
    ``b + 4`` poses with ``2b`` edges, the first ``b`` of them the loop
    edges that the matches refresh."""
    import torch

    from laser_slam_tpu_torch.core import se2
    from laser_slam_tpu_torch.graph.solve import PoseGraph

    v = b + 4
    rng = np.random.default_rng(0)
    poses = np.cumsum(rng.normal(0, 0.1, (v, 3)).astype(np.float32), axis=0)
    e = 2 * b
    ei = np.arange(e, dtype=np.int64) % (v - 1)
    ej = ei + 1
    p = torch.as_tensor(poses)
    meas = se2.relative(p[ei], p[ej])
    info = np.tile(np.eye(3, dtype=np.float32) * 50.0, (e, 1, 1))
    return PoseGraph(
        poses=p.to(device), v_active=torch.ones(v, dtype=torch.bool, device=device),
        i=torch.as_tensor(ei, device=device), j=torch.as_tensor(ej, device=device),
        meas=meas.to(device), info=torch.as_tensor(info, device=device),
        e_active=torch.ones(e, dtype=torch.bool, device=device),
    )


def main() -> None:
    coordinator, nprocs, pid = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    device = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from laser_slam_tpu_torch.core.scan import LMS211
    from laser_slam_tpu_torch.parallel import multihost
    from laser_slam_tpu_torch.parallel.distributed import training_step
    from laser_slam_tpu_torch.parallel.mesh import local_device

    if device == "cuda":
        # Ranks that share one card cannot form an NCCL group; they talk
        # over gloo with the card's tensors (a CPU mesh, CUDA data).
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                world_size=nprocs, rank=pid)
    multihost.initialize(coordinator=coordinator, num_processes=nprocs, process_id=pid,
                         device=device)
    world = dist.get_world_size()
    assert world == nprocs, world
    mesh = multihost.global_mesh()
    dev = torch.device(device) if device == "cuda" else local_device(mesh)
    b = 2 * world
    ref, cur, _ = synthetic_pairs(LMS211, b, seed=0, device=dev)
    graph = dryrun_graph(b, device=dev)
    poses, chi, fail = training_step(mesh, LMS211, ref, cur, graph)
    chi_v = float(chi)
    fails = int(fail.sum())
    assert poses.shape == (b + 4, 3) and bool(torch.isfinite(poses).all())
    assert np.isfinite(chi_v)
    assert fails == 0, f"{fails}/{b} trivial pairs failed"
    print(f"MULTIPROC_OK pid={pid}/{nprocs} devices={world} pairs={b} "
          f"chi2={chi_v:.9g} fails={fails}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
