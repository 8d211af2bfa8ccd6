"""Submap hierarchy: keyframe groups reduced to fixed-shape local clouds
(port of ``graph/submap.py``).

- **reduction**: all beam endpoints of a group are expressed in the
  group-anchor frame and deduplicated at submap resolution by voxel key
  (stable sort + first-occurrence mask), compacted to a fixed ``P``
  points per submap; batched over the submaps.
- **wide clouds**: submaps ``i-wing..i+wing`` merged into anchor ``i``'s
  frame, the local context loop verification matches against.
- **bounding boxes** under the current anchor poses;
- **verification** of loop candidates submap against submap.

Everything is fixed-shape: groups with fewer valid points carry masks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..core import se2
from ..core.scan import LaserModel, Scan
from .loop_closure import LoopCandidates, VerifiedLoops, icp_both_ways, icp_loop_gates

Tensor = torch.Tensor

SUBMAP_RESOLUTION = 0.05   # [m] voxel size of the dedup
DEFAULT_MAX_POINTS = 768


class Submaps(NamedTuple):
    """A batch of ``S`` submaps with fixed ``P`` points each.

    ``points`` live in each submap's **anchor frame** (the first keyframe
    of its group), so they never need rebuilding when the graph solver
    moves the anchors.
    """

    points: Tensor       # [S, P, 2] anchor-frame deduped endpoints
    valid: Tensor        # [S, P] bool
    anchor_idx: Tensor   # [S] index of the anchor scan in the full log


def reduce_group(
    pts_local: Tensor,
    valid: Tensor,
    rel_poses: Tensor,
    max_points: int = DEFAULT_MAX_POINTS,
    resolution: float = SUBMAP_RESOLUTION,
) -> tuple[Tensor, Tensor]:
    """Reduce groups of ``K`` scans into ≤ ``max_points`` anchor-frame
    points each: ``([S, max_points, 2], [S, max_points] bool)``
    (``K·N`` where that is smaller).

    ``pts_local [S, K, N, 2]`` are sensor-frame endpoints, ``valid
    [S, K, N]`` their masks, ``rel_poses [S, K, 3]`` the scan poses in
    the anchor frame. Of the points of one voxel the first (in scan,
    then beam order) survives: both sorts are stable.
    """
    s, k, n, _ = pts_local.shape
    pts = se2.transform_points(rel_poses, pts_local).reshape(s, k * n, 2)
    ok = valid.reshape(s, k * n)

    # Voxel key at submap resolution; invalid points get a sentinel key
    # that sorts last. Anchor-frame coordinates are bounded by the sensor
    # range, so 13 bits per axis fit an int32 key. The division by the
    # constant is a multiplication by its float32 reciprocal.
    inv = float(np.float32(1.0) / np.float32(resolution))
    q = torch.clamp(torch.floor(pts * inv).to(torch.int32) + 4096, 0, 8191)
    sentinel = 1 << 30
    key = torch.where(ok, q[..., 0] * 8192 + q[..., 1], sentinel)

    with record_function("h4_sort"):
        key_s, order = torch.sort(key, dim=-1, stable=True)
        first = torch.cat(
            [torch.ones_like(ok[:, :1]), key_s[:, 1:] != key_s[:, :-1]], dim=-1
        ) & (key_s < sentinel)
        # Compact the first occurrences to the front, voxel order kept.
        rank = torch.sort((~first).to(torch.uint8), dim=-1, stable=True).indices
    take = torch.gather(order, 1, rank[:, :max_points])
    out_ok = torch.gather(first, 1, rank[:, :max_points])
    out_pts = torch.gather(pts, 1, take[..., None].expand(-1, -1, 2))
    return torch.where(out_ok[..., None], out_pts, 0.0), out_ok


def build_submaps(
    model: LaserModel,
    scans: Scan,
    poses: Tensor,
    stride: int,
    max_points: int = DEFAULT_MAX_POINTS,
    resolution: float = SUBMAP_RESOLUTION,
) -> Submaps:
    """Group a ``[T, N]`` scan log into ``S = T // stride`` submaps of
    ``stride`` consecutive scans each and reduce every group."""
    dev = scans.ranges.device
    t = scans.ranges.shape[0]
    s = t // stride
    anchor_idx = torch.arange(s, device=dev) * stride

    fi = model.bearings(scans.ranges.dtype, dev)
    pts = torch.stack(
        [scans.ranges * torch.cos(fi), scans.ranges * torch.sin(fi)], dim=-1
    )
    ok = (
        ~scans.bad
        & (scans.ranges < model.max_range)
        & (scans.ranges > model.min_range)
    )
    cut = s * stride
    pts_g = pts[:cut].reshape(s, stride, -1, 2)
    ok_g = ok[:cut].reshape(s, stride, -1)
    poses_g = poses[:cut].reshape(s, stride, 3)
    rel_g = se2.relative(poses_g[:, :1, :], poses_g)      # anchor-frame poses
    out_pts, out_ok = reduce_group(pts_g, ok_g, rel_g, max_points, resolution)
    return Submaps(points=out_pts, valid=out_ok, anchor_idx=anchor_idx)


def wide_clouds(
    submaps: Submaps,
    odo_anchor_poses: Tensor,
    wing: int = 4,
    max_points: int = 1536,
    resolution: float = 2.0 * SUBMAP_RESOLUTION,
    block_id: Tensor | None = None,
) -> tuple[Tensor, Tensor]:
    """Per-anchor *wide* clouds: submaps ``i-wing..i+wing`` merged into
    anchor ``i``'s frame via the (locally accurate) odometry relatives,
    ``(points [S, max_points, 2], valid [S, max_points])``.

    Loop verification against a single 10-scan submap suffers partial
    overlap: an opposite-direction revisit's submap extends away from
    the anchor the other way, the overlapping fraction is small and
    aliased alignments outscore the true one. Matching against this
    wide local context restores containment. With ``block_id``, context
    is never merged across an odometry fracture: the relative pose
    between blocks is unknown.
    """
    s = submaps.points.shape[0]
    dev = submaps.points.device
    offs = torch.arange(-wing, wing + 1, device=dev)
    raw = torch.arange(s, device=dev)[:, None] + offs[None, :]        # [S, K]
    idx = torch.clamp(raw, 0, s - 1)
    in_range = (raw >= 0) & (raw < s)
    if block_id is not None:
        in_range = in_range & (block_id[idx] == block_id[:, None])
    pts_g = submaps.points[idx]                                       # [S, K, P, 2]
    ok_g = submaps.valid[idx] & in_range[..., None]
    rel_g = se2.relative(odo_anchor_poses[:, None, :], odo_anchor_poses[idx])
    return reduce_group(pts_g, ok_g, rel_g, max_points, resolution)


def submap_bboxes(submaps: Submaps, anchor_poses: Tensor) -> tuple[Tensor, Tensor]:
    """World-frame AABBs ``(lo [S,2], hi [S,2])`` of each submap under
    the current anchor poses."""
    w = se2.transform_points(anchor_poses, submaps.points)
    ok = submaps.valid[..., None]
    lo = torch.where(ok, w, 1e9).amin(dim=1)
    hi = torch.where(ok, w, -1e9).amax(dim=1)
    return lo, hi


def verify_loops_submap(
    submaps: Submaps,
    anchor_poses: Tensor,
    cand: LoopCandidates,
    max_corr: float = 1.5,
) -> VerifiedLoops:
    """Verify loop candidates submap against submap with trimmed point
    ICP from the current estimates, forward and backward in one batch,
    under the gates of scan-level verification
    (``loop_closure.icp_loop_gates``)."""
    init = se2.relative(anchor_poses[cand.src], anchor_poses[cand.dst])
    fwd, bwd = icp_both_ways(submaps.points[cand.src], submaps.valid[cand.src],
                             submaps.points[cand.dst], submaps.valid[cand.dst], init, max_corr)
    accept = icp_loop_gates(cand.valid, init, fwd, bwd)
    rel = torch.where(accept[:, None], torch.nan_to_num(fwd.pose), 0.0)
    return VerifiedLoops(src=cand.src, dst=cand.dst, rel=rel, quality=fwd.goodness, accept=accept)
