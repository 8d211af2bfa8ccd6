"""Shared incremental loop-closure backend (port of
``runtime/backend.py``).

One component drives the init-free correlative backend for every online
topology. State that persists across rounds: per-anchor-group submap
clouds, the verified-loop bank, and the tried-pair matrix, all on the
host in numpy; a round's tensors live on the session's device while it
runs. Anchors live in power-of-two capacity buckets: inactive anchors
take part in the signature gate's top-k and in the wide clouds as masked
rows, so a round's result is a function of the capacity too, and the
capacities are the original's.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import se2
from ..core.device import resolve_device
from ..core.scan import LaserModel, Scan
from ..graph.submap import Submaps, reduce_group
from .slam import HINGE_WEIGHT, SlamConfig, run_correlative_rounds


class IncrementalBackend:
    """Incremental correlative loop closure + robust solve.

    Stateless w.r.t. the caller's per-scan records: each :meth:`round`
    receives the session-so-far (scans, poses, raw odometry chain,
    weak/fracture flags) and returns the rebased per-scan trajectory, or
    ``None`` when fewer than 8 anchor groups are complete. Submap
    reductions, the loop bank, and the tried matrix persist here.

    Runs on ``device``: ``cuda`` unless the caller names another, and
    then construction raises where there is no CUDA device.
    """

    MIN_GROUPS = 8

    def __init__(self, model: LaserModel, cfg: SlamConfig = SlamConfig(),
                 device: torch.device | str | None = None):
        self.model = model
        self.cfg = cfg
        self.device = resolve_device(device)
        self._group_pts: list[np.ndarray] = []  # per-anchor submap clouds
        self._group_ok: list[np.ndarray] = []
        self._bank = None
        self._tried: np.ndarray | None = None
        self.n_loops = 0
        self._last_round_wall = 0.0   # [s] wall of the latest round

    # -- submap reduction ------------------------------------------------

    def _build_group_submaps(self, all_scans: list[Scan], odo_chain, t: int) -> None:
        """Reduce every newly completed anchor group of ``stride`` scans
        into a fixed-budget submap cloud, all of them in one call."""
        stride = self.cfg.anchor_stride
        g0, n_ready = len(self._group_pts), t // stride
        if n_ready <= g0:
            return
        lo, hi = g0 * stride, n_ready * stride
        dev = self.device
        ranges = torch.stack([s.ranges for s in all_scans[lo:hi]]).to(dev)
        bad = torch.stack([s.bad for s in all_scans[lo:hi]]).to(dev)
        fi = self.model.bearings(ranges.dtype, dev)
        pts = torch.stack([ranges * torch.cos(fi), ranges * torch.sin(fi)], dim=-1)
        ok = ~bad & (ranges < self.model.max_range) & (ranges > self.model.min_range)
        odo = torch.as_tensor(np.stack(odo_chain[lo:hi]), dtype=ranges.dtype, device=dev)
        odo = odo.reshape(n_ready - g0, stride, 3)
        rel_g = se2.relative(odo[:, :1], odo)
        out_pts, out_ok = reduce_group(
            pts.reshape(n_ready - g0, stride, -1, 2), ok.reshape(n_ready - g0, stride, -1),
            rel_g, self.cfg.submap_points,
        )
        self._group_pts.extend(out_pts.cpu().numpy())
        self._group_ok.extend(out_ok.cpu().numpy())

    # -- one backend round -----------------------------------------------

    def round(
        self,
        all_scans: list[Scan],
        poses: list[np.ndarray],
        odo_chain: list[np.ndarray],
        weak: list[bool],
        fracture: list[bool],
    ) -> np.ndarray | None:
        """Run one correlative backend round over the session so far.

        Every round, the end-of-stream one included, runs ONE wave: extra
        end-of-session waves hurt, because the tried matrix already
        excludes every plausible pair by then, so additional waves verify
        only leftover long-radius candidates and admit perceptual aliases
        (offline's multi-wave schedule works because it shapes the gates
        from round 0).

        Returns the rebased per-scan trajectory ``[T, 3]``, or ``None`` if
        not enough anchor groups are complete yet."""
        t_start = time.perf_counter()
        dev = self.device
        stride = self.cfg.anchor_stride
        t = len(all_scans)
        self._build_group_submaps(all_scans, odo_chain, t)
        n = len(self._group_pts)
        if n < self.MIN_GROUPS:
            return None
        cap = 64
        while cap < n:
            cap *= 2
        p = self.cfg.submap_points
        pts = np.zeros((cap, p, 2), np.float32)
        okm = np.zeros((cap, p), bool)
        pts[:n] = np.stack(self._group_pts)
        okm[:n] = np.stack(self._group_ok)
        submaps = Submaps(
            points=torch.as_tensor(pts, device=dev), valid=torch.as_tensor(okm, device=dev),
            anchor_idx=torch.arange(cap, device=dev) * stride,
        )

        ap = np.zeros((cap, 3), np.float32)
        oa = np.zeros((cap, 3), np.float32)
        for i in range(n):
            ap[i] = poses[i * stride]
            oa[i] = odo_chain[i * stride]
        oat = torch.as_tensor(oa, device=dev)
        rel_seq = torch.zeros(cap - 1, 3, dtype=torch.float32, device=dev)
        rel_seq[:n - 1] = se2.relative(oat[:n - 1], oat[1:n])

        seq_w = np.zeros(cap - 1, np.float32)   # 0 ⇒ inactive edge
        block = np.zeros(cap, np.int64)
        b = 0
        for e in range(n - 1):
            lo, hi = e * stride + 1, min((e + 1) * stride + 1, len(weak))
            frac = any(fracture[lo:hi])
            wk = any(weak[lo:hi])
            seq_w[e] = (
                HINGE_WEIGHT if frac
                else (self.cfg.weak_seq_weight if wk else 1.0)
            )
            if frac:
                b += 1
            block[e + 1] = b
        block[n:] = b

        tried = np.ones((cap, cap), bool)       # inactive ⇒ never proposed
        tried[:n, :n] = False
        if self._tried is not None:
            m = self._tried.shape[0]
            tried[:m, :m] = self._tried

        cfg_r = dataclasses.replace(
            self.cfg, rounds=1, cov_rounds=0,
            # Incremental sessions accumulate many short-gap local
            # accepts across their ~N/optimize_every rounds; a doubled
            # bank keeps the long-gap global constraints from being
            # evicted when the cap binds (SlamConfig.bank_cap).
            bank_cap=(self.cfg.bank_cap or 2 * self.cfg.max_loops),
            # Anchored tentative promotion is validated offline only: its
            # residual bounds assume the estimate has already absorbed
            # the round-0 full-budget wave. On the incremental schedule
            # the estimate is still drift-sized when tentatives arrive,
            # and odometry-cycle-consistent + drift-sized-residual
            # selects exactly the drift-confirming narrow-lane aliases.
            promote_tentative=False,
        )
        ap_new, n_loops, _chi, bank, tried_t = run_correlative_rounds(
            cfg_r, submaps, torch.as_tensor(ap, device=dev), rel_seq,
            torch.as_tensor(seq_w, device=dev), bank=self._bank,
            tried=torch.as_tensor(tried, device=dev),
            odo_anchor_poses=oat, block_id=torch.as_tensor(block, device=dev),
        )
        self._bank = bank
        self._tried = tried_t.cpu().numpy()[:n, :n]
        self.n_loops = int(n_loops)
        new_anchor_poses = ap_new.cpu().numpy()[:n]

        # Rebase all per-scan poses onto the optimized anchors; offsets
        # come from the OLD anchor poses.
        old = np.stack(poses)
        t_all = np.arange(old.shape[0])
        seg = np.minimum(t_all // stride, n - 1)
        rel = se2.np_relative(old[seg * stride], old)
        out = se2.np_compose(new_anchor_poses[seg], rel).astype(np.float32)
        self._last_round_wall = time.perf_counter() - t_start
        return out
