"""Pose-free loop-candidate proposal: invariant submap signatures (port
of ``graph/place_recognition.py``).

On a long trajectory the odometry estimate drifts beyond any usable
search gate, so candidate proposal cannot rely on estimated poses alone.
Each submap gets a *global* descriptor that is invariant to the unknown
relative pose, compared for all pairs in one matrix operation:

- **signature**: the histogram of pairwise point distances inside the
  submap cloud (the D2 shape distribution); rigid motions preserve all
  pairwise distances, so no pose estimate enters at any point;
- **similarity**: χ² distance between histograms for all anchor pairs.

Signatures only *rank* candidates; every proposed pair still passes the
full correlative + ICP + reciprocity verification.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

DEFAULT_BINS = 32
DEFAULT_DMAX = 16.0
DEFAULT_SAMPLE = 384


def submap_signatures(
    points: Tensor,
    valid: Tensor,
    bins: int = DEFAULT_BINS,
    dmax: float = DEFAULT_DMAX,
    sample: int = DEFAULT_SAMPLE,
    chunk: int = 32,
) -> Tensor:
    """Normalized pairwise-distance histograms ``[S, bins]`` of submap
    clouds ``points [S, P, 2]`` / ``valid [S, P]``.

    Points are strided down to ``sample`` per submap before the O(P²)
    distance matrix; submaps are processed ``chunk`` at a time to bound
    live memory.
    """
    s, p, _ = points.shape
    dtype, dev = points.dtype, points.device
    stride = max(p // sample, 1)
    pts = points[:, ::stride]
    ok = valid[:, ::stride]
    m = pts.shape[1]
    not_self = 1.0 - torch.eye(m, dtype=dtype, device=dev)
    out = []
    for i in range(0, s, chunk):
        pc, oc = pts[i:i + chunk], ok[i:i + chunk]
        c = pc.shape[0]
        diff = pc[:, :, None, :] - pc[:, None, :, :]
        d = torch.sqrt(torch.sum(diff * diff, dim=-1))                # [c, m, m]
        # zero self-distances excluded
        w = (oc[:, :, None] & oc[:, None, :]).to(dtype) * not_self
        b = torch.clamp((d / dmax * bins).to(torch.int64), 0, bins - 1)
        b = b + torch.arange(c, device=dev)[:, None, None] * bins
        hist = torch.zeros(c * bins, dtype=dtype, device=dev).index_add_(
            0, b.reshape(-1), w.reshape(-1)
        ).reshape(c, bins)
        out.append(hist / torch.clamp(hist.sum(dim=-1, keepdim=True), min=1.0))
    return torch.cat(out)


def signature_affinity(sigs: Tensor) -> Tensor:
    """``[A, A]`` similarity in (0, 1]: ``exp(-χ²/2)`` of histogram
    pairs. Symmetric; diagonal is 1."""
    a = sigs[:, None, :]
    b = sigs[None, :, :]
    chi2 = torch.sum((a - b) ** 2 / (a + b + 1e-9), dim=-1)
    return torch.exp(-0.5 * chi2)


def signature_gate(
    sigs: Tensor,
    min_gap: int,
    per_dst: int = 6,
    min_affinity: float = 0.5,
) -> Tensor:
    """``[A, A]`` bool: pairs ``i < j - min_gap`` whose signatures rank
    in ``j``'s top ``per_dst`` most-similar earlier anchors and clear
    ``min_affinity``. Purely appearance-based, usable at any drift.
    Only the value of the ``per_dst``-th best enters (every pair at or
    above it is kept), so the order among equal affinities plays no part."""
    a = sigs.shape[0]
    aff = signature_affinity(sigs)
    ii = torch.arange(a, device=sigs.device)
    ordered = (ii[None, :] - ii[:, None]) > min_gap
    score_t = torch.where(ordered, aff, -torch.inf).T                 # [dst, src]
    kth = torch.topk(score_t, min(per_dst, a), dim=-1).values[:, -1]
    keep = (score_t >= kth[:, None]) & (score_t >= min_affinity)
    return keep.T & ordered
