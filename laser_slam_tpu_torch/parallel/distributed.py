"""Distributed SLAM compute: sharded matching and the edge-sharded pose-graph
solve (port of ``parallel/distributed.py``) over ``torch.distributed``.

- :func:`sharded_batch_match`: every rank holds the whole pair batch,
  matches its rows and ``all_gather_into_tensor`` returns the whole
  result, in rank order, on every rank. PSM on CUDA tensors runs the
  fused kernel's batch entry (``match_psm_fused``). A pair's result does
  not depend on the pairs beside it: the matchers freeze a pair once it
  has converged or failed. (On the CPU, torch's ``atan2`` rounds the last
  bit by the batch's size, so ranks agree with one rank to round-off.)
- :func:`distributed_optimize`: the poses are replicated, the edges
  sliced by rank. Each rank assembles its edges' normal equations and
  χ²; ``all_reduce`` sums them, and every rank runs the same LM (the
  ``reduce`` of ``graph.solve.optimize``). An edge count that does not
  split over the ranks is padded with inactive edges.
- :func:`training_step`: the sharded PSM, the loop-edge measurements
  refreshed from it, the distributed solve.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.scan import LaserModel, Scan
from ..graph.solve import PoseGraph, optimize
from ..ops.cuda.psm_kernel import match_psm_fused
from ..ops.icp import match_icp
from ..ops.plicp import match_plicp
from .mesh import rank_and_size, rows_of_rank

MATCHERS = {"psm": match_psm_fused, "icp": match_icp, "plicp": match_plicp}


def _all_gather(x: torch.Tensor, group, size: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along the leading axis in rank order
    (bool travels as uint8)."""
    src = x.contiguous()
    if src.dtype == torch.bool:
        return _all_gather(src.view(torch.uint8), group, size).view(torch.bool)
    out = torch.empty((size * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)   # renamed in newer torch
        dist.all_gather_into_tensor(out, src, group=group)
    return out


def sharded_batch_match(
    mesh: DeviceMesh,
    model: LaserModel,
    ref_batch: Scan,
    cur_batch: Scan,
    init_poses: torch.Tensor | None = None,
    matcher: str = "psm",
):
    """Match ``B`` scan pairs (``[B, N]`` on every rank) with the batch
    split across the mesh; returns the matcher's result for all ``B``
    pairs on every rank.

    ``B`` must be divisible by the mesh size (use
    :func:`.mesh.pad_to_multiple`).
    """
    fn = MATCHERS[matcher]
    rank, size = rank_and_size(mesh)
    b = cur_batch.ranges.shape[0]
    rows = rows_of_rank(b, rank, size)
    if init_poses is None:
        init_poses = torch.zeros(b, 3, dtype=cur_batch.ranges.dtype, device=cur_batch.ranges.device)
    local = fn(model, Scan(*(x[rows].contiguous() for x in ref_batch)),
               Scan(*(x[rows].contiguous() for x in cur_batch)), init_poses[rows].contiguous())
    group = mesh.get_group()
    return type(local)(*(_all_gather(x, group, size) for x in local))


def _pad_inactive(g: PoseGraph, pad: int) -> PoseGraph:
    """``pad`` more edges that are inactive (0 → 0, zero measurement and
    information), which add nothing to any sum."""
    def more(x, fill=0):
        return torch.cat([x, torch.full((pad,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                                        device=x.device)])

    return g._replace(i=more(g.i), j=more(g.j), meas=more(g.meas), info=more(g.info),
                      e_active=more(g.e_active, False),
                      kernel=None if g.kernel is None else more(g.kernel))


def _edges_of_rank(g: PoseGraph, rank: int, size: int) -> PoseGraph:
    """This rank's slice of the edges (padded with inactive ones to a
    multiple of ``size``)."""
    pad = (-g.i.shape[0]) % size
    if pad:
        g = _pad_inactive(g, pad)
    rows = rows_of_rank(g.i.shape[0], rank, size)
    return g._replace(i=g.i[rows], j=g.j[rows], meas=g.meas[rows], info=g.info[rows],
                      e_active=g.e_active[rows],
                      kernel=None if g.kernel is None else g.kernel[rows])


def _all_reduce_sum(mesh: DeviceMesh):
    """A ``reduce`` for ``graph.solve.optimize``: the sum over the mesh's
    ranks, in place on the buffer it is given."""
    group = mesh.get_group()

    def reduce(t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    return reduce


def distributed_optimize(mesh: DeviceMesh, graph: PoseGraph, max_iters: int = 20,
                         info: dict | None = None):
    """Pose-graph optimization with the edges split over the mesh and the
    poses replicated; returns ``(graph, final weighted χ²)`` as
    ``graph.solve.optimize`` does, the same on every rank."""
    rank, size = rank_and_size(mesh)
    local = _edges_of_rank(graph, rank, size)
    g_opt, chi = optimize(local, max_iters, info=info, reduce=_all_reduce_sum(mesh))
    return graph._replace(poses=g_opt.poses), chi


def training_step(
    mesh: DeviceMesh,
    model: LaserModel,
    ref_batch: Scan,
    cur_batch: Scan,
    graph: PoseGraph,
):
    """One distributed SLAM backend step: sharded loop-candidate
    verification (PSM) → the first ``B`` loop-edge measurements refreshed
    where the match did not fail → 5 LM iterations of the edge-sharded
    solve. Returns ``(poses [V, 3], χ², fail [B])``, the same on every
    rank.
    """
    res = sharded_batch_match(mesh, model, ref_batch, cur_batch, matcher="psm")
    b = res.pose.shape[0]
    head = torch.where(res.fail[:, None], graph.meas[:b], res.pose)
    g = graph._replace(meas=torch.cat([head, graph.meas[b:]]))
    g_opt, chi = distributed_optimize(mesh, g, 5)
    return g_opt.poses, chi, res.fail
