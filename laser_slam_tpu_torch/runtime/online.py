"""Online incremental SLAM session (port of ``runtime/online.py``).

Feed scans (and optionally beacon / GPS readings) one at a time, get
poses out, with the backend (loop closure + graph solve) folded in
periodically. The frontend step is one fused PSM launch of two pairs and
the selects that settle it, with one fetch to the host a scan; the live
map and the filter follow on the device; the backend round is the
machinery of ``slam_offline``; the host merely sequences them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable

import numpy as np
import torch

from ..core import se2
from ..core.device import resolve_device
from ..core.scan import LaserModel, Scan, stack_scans
from ..fusion import ukf
from ..mapping.incremental import IncrementalMapper
from ..mapping.occupancy import empty_grid, integrate_scans, spec_for_trajectory
from ..ops.odometry import _OdoCarry, _step_deep, _step_flagged
from ..ops.preprocess import preprocess
from ..utils.checkpoint import load_pytree, save_pytree
from .backend import IncrementalBackend
from .slam import SlamConfig


@dataclasses.dataclass
class OnlineSlam:
    """Incremental SLAM session.

    Usage::

        slam = OnlineSlam(model)
        for ranges, t in sensor:
            pose = slam.feed_scan(ranges)
        grid = slam.render_map()

    The session's tensors live on ``device``: ``cuda`` unless the caller
    names another, and then construction raises where there is no CUDA
    device.
    """

    model: LaserModel
    cfg: SlamConfig = SlamConfig()
    optimize_every: int = 10            # anchors between backend rounds
    on_pose: Callable | None = None
    use_fusion: bool = False
    incremental_map: bool = True        # live grid (O(1)/scan)
    map_resolution: float = 0.1
    map_half_size: float = 60.0
    async_backend: bool = False         # run backend rounds on a host
    #                                     thread (on a CUDA device: on a
    #                                     stream of its own): feed_scan
    #                                     never waits for a round;
    #                                     corrections apply on completion
    device: torch.device | str | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # Scheduler bookkeeping (deterministic — tests assert on these,
        # not on wall-clock): requested = backend rounds asked for;
        # started = worker rounds actually launched; applied = results
        # spliced back; coalesced = requests that found a round already
        # in flight and were folded into ONE pending follow-up (the
        # backlog is bounded at a single pending round by construction).
        self.async_stats = {
            "requested": 0, "started": 0, "applied": 0, "coalesced": 0,
            # Scans fed between a round's snapshot and its application:
            # > 0 proves the frontend ran while the backend was in
            # flight (the deterministic overlap witness).
            "overlap_scans_max": 0,
        }
        self._pending_round = False
        self._carry: _OdoCarry | None = None
        self._scans: list[Scan] = []        # anchor scans
        self._all_scans: list[Scan] = []    # every scan, never mutated
        self._poses: list[np.ndarray] = []  # per-scan poses
        self._weak: list[bool] = []
        self._fracture: list[bool] = []
        # Raw odometry chain (never rebased): the PCM/drift reference
        # for the correlative backend, like slam_offline's
        # odo_anchor_poses.
        self._odo_chain: list[np.ndarray] = []
        # Correlative-backend session state (submap clouds, loop bank,
        # tried-pair matrix) lives in the shared incremental backend.
        self._backend = IncrementalBackend(self.model, self.cfg, device=self.device)
        self.n_loops = 0
        self._bg_thread: threading.Thread | None = None   # in-flight async round
        self._bg_result = None              # (rebased, t_snapshot)
        self._bg_error: Exception | None = None   # what ended the worker's round
        self._bg_stream = None              # the worker's CUDA stream
        self._t = 0
        self.last_scan: Scan | None = None
        dev = self.device
        self._fusion = (
            ukf.init(torch.zeros(3, device=dev), 0.01) if self.use_fusion else None
        )
        self._fusion_t: torch.Tensor | float = -float("inf")
        self._gps_t = -float("inf")
        self._true = torch.ones((), dtype=torch.bool, device=dev)
        self._no_beacon = (torch.zeros(2, device=dev), torch.zeros((), dtype=torch.bool, device=dev))
        self._imap = None
        if self.incremental_map:
            self._imap = IncrementalMapper(
                self.model,
                resolution=self.map_resolution,
                half_size=self.map_half_size,
                device=dev,
            )

    # -- sensor inputs ----------------------------------------------------

    def feed_scan(self, ranges) -> np.ndarray:
        """Process one scan ``[N]``; returns the current global pose [3]."""
        if self.async_backend:
            self._poll_backend()
        dev = self.device
        scan = preprocess(
            torch.as_tensor(np.asarray(ranges, np.float32)).to(dev), self.model)
        # Cache the preprocessed scan so downstream consumers (local map,
        # obstacle layer) reuse it instead of re-running preprocess.
        self.last_scan = scan
        if self._carry is None:
            zero = torch.zeros(3, dtype=torch.float32, device=dev)
            self._carry = _OdoCarry(
                ref=scan, last=scan, ref_gpose=zero, last_gpose=zero,
                prior_rel=zero,
            )
            self._poses.append(np.zeros(3, np.float32))
            self._weak.append(False)
            self._fracture.append(False)
            self._odo_chain.append(np.zeros(3, np.float32))
            self._maybe_anchor(scan, 0)
            self._t = 1
            if self._imap is not None:
                self._imap.add(scan, self._poses[-1])
            return self._poses[-1]

        # The step with the exhaustive fallback inline. Whether the scan
        # needs the fallback is data on the device: it comes to the host
        # in the scan's one fetch, with the provisional pose, and only the
        # rare scan that needs it is finished (and fetched) a second time.
        before = self._carry
        self._carry, (pose, _switched, _discarded, deep), psm_rel = _step_flagged(
            self.model, before, scan)
        out = torch.cat([pose, deep[None].to(pose.dtype)]).cpu().numpy()
        weak = frac = False
        if out[3]:
            self._carry, (pose, _switched, _discarded, weak_t, frac_t) = _step_deep(
                self.model, before, scan, psm_rel)
            out = torch.cat([pose, torch.stack([weak_t, frac_t]).to(pose.dtype)]).cpu().numpy()
            weak, frac = bool(out[3]), bool(out[4])
        pose_np = out[:3].copy()
        self._fracture.append(frac)
        rel_step = se2.np_relative(self._poses[-1][None], pose_np[None])[0]
        self._odo_chain.append(
            se2.np_compose(
                self._odo_chain[-1][None], rel_step[None]
            )[0].astype(np.float32)
        )
        self._poses.append(pose_np)
        self._weak.append(weak)
        self._maybe_anchor(scan, self._t)
        self._t += 1
        if self._imap is not None:
            self._imap.add(scan, pose_np)

        if self.use_fusion:
            # One upload a scan: the odometry increment (from the host's
            # poses, which a rebase may have moved), the pose, the stamp.
            rel = se2.np_relative(self._poses[-2], pose_np).astype(np.float32)
            inp = torch.from_numpy(
                np.concatenate([rel, pose_np, [np.float32(self._t)]]).astype(np.float32)
            ).to(dev)
            self._fusion, self._fusion_t = ukf.fusion_step(
                self._fusion,
                ukf.FusionInputs(
                    odom_rel=inp[0:3],
                    odom_valid=self._true,
                    slam_pose=inp[3:6],
                    slam_valid=self._true,
                    beacon_xy=self._no_beacon[0],
                    beacon_valid=self._no_beacon[1],
                    slam_t=inp[6],
                ),
                filter_t=self._fusion_t,
            )
        if self.on_pose is not None:
            self.on_pose(pose_np)
        return pose_np

    def feed_beacon(self, xy) -> None:
        if self._fusion is not None:
            self._fusion = ukf.update_partial(
                self._fusion, (0, 1), self._to_device(xy), 0.25
            )

    def feed_gps(self, obs, r: float = 1.0) -> None:
        """GPS position observe with timestamp gating.

        ``obs`` is an object with ``east``, ``north`` and ``t`` (ENU
        assumed aligned with the SLAM frame at session start) or a bare
        ``(east, north)`` pair. A stale or out-of-order fix (timestamp ≤
        the last consumed one) is skipped.
        """
        if self._fusion is None:
            return
        t = None
        if hasattr(obs, "east"):
            xy = self._to_device([obs.east, obs.north])
            t = float(obs.t)
        else:
            xy = self._to_device(obs)[:2]
        if t is not None:
            if t <= self._gps_t:
                return
            self._gps_t = t
        self._fusion = ukf.update_partial(self._fusion, (0, 1), xy, r)

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.float32)).to(self.device)

    # -- state access ---------------------------------------------------

    @property
    def pose(self) -> np.ndarray:
        """The fused pose (the filter's one fetch), or the last scan's."""
        if self._fusion is not None:
            return self._fusion.mean.cpu().numpy()
        return self._poses[-1] if self._poses else np.zeros(3, np.float32)

    @property
    def trajectory(self) -> np.ndarray:
        return np.stack(self._poses) if self._poses else np.zeros((0, 3))

    def render_map(self, resolution: float = 0.05):
        # The live incremental grid is already up to date — no rebuild —
        # but it has a fixed arena (center ± half_size, rebased past the
        # bigChange gate); a trajectory that left the arena would render
        # silently truncated, so fall back to a full-extent rebuild then.
        if self._imap is not None and resolution == self.map_resolution:
            if self._imap.covers(self.trajectory):
                return self._imap.grid

        traj = self.trajectory
        spec = spec_for_trajectory(traj, self.model.max_range, resolution)
        return integrate_scans(
            empty_grid(spec, device=self.device), self.model, stack_scans(self._all_scans),
            torch.as_tensor(traj, dtype=torch.float32).to(self.device),
        )

    def local_map(self, pose=None, half_cells: int = 64):
        """Egocentric window of the live grid; O(1): a copy of a slice,
        never a rebuild."""
        if self._imap is None:
            raise RuntimeError("incremental_map is disabled")
        if pose is None:
            pose = self.pose
        return self._imap.local_crop(pose, half_cells)

    # -- checkpoint / resume ---------------------------------------------
    # A session snapshots to one .npz and resumes mid-log. The file holds
    # the per-scan records and the frontend carry; the loop bank and the
    # filter start anew in the resumed session.

    def save(self, path: str) -> None:
        state = {
            "poses": np.stack(self._poses) if self._poses else np.zeros((0, 3)),
            "weak": np.asarray(self._weak, bool),
            "fracture": np.asarray(self._fracture, bool),
            "odo_chain": (
                np.stack(self._odo_chain) if self._odo_chain
                else np.zeros((0, 3))
            ),
            "carry": self._carry,
            "all_scans": stack_scans(self._all_scans) if self._all_scans else None,
        }
        save_pytree(
            path, state,
            meta={
                "t": self._t,
                "n_anchors": len(self._scans),
                "anchor_stride": self.cfg.anchor_stride,
                "model": self.model.name,
            },
        )

    @classmethod
    def resume(cls, model: LaserModel, path: str, **kwargs) -> "OnlineSlam":
        flat, meta = load_pytree(path)
        if meta["model"] != model.name:
            raise ValueError(
                f"checkpoint is for model {meta['model']}, got {model.name}"
            )
        slam = cls(model, **kwargs)
        dev = slam.device
        poses = flat["poses"]
        slam._poses = [np.asarray(poses[i], np.float32) for i in range(poses.shape[0])]
        slam._weak = [bool(b) for b in flat["weak"]]
        slam._fracture = [bool(b) for b in flat.get(
            "fracture", np.zeros(poses.shape[0], bool)
        )]
        oc = flat.get("odo_chain")
        if oc is None or oc.shape[0] != poses.shape[0]:
            # Old checkpoints: fall back to the saved trajectory as the
            # odometry reference (pre-rebase detail is lost).
            oc = poses
        slam._odo_chain = [np.asarray(oc[i], np.float32) for i in range(oc.shape[0])]
        slam._t = int(meta["t"])
        stride = int(meta["anchor_stride"])

        def scan_at(prefix: str) -> Scan:
            return Scan(
                ranges=torch.as_tensor(flat[prefix + "/ranges"], dtype=torch.float32).to(dev),
                bad=torch.as_tensor(flat[prefix + "/bad"], dtype=torch.bool).to(dev),
                seg=torch.as_tensor(flat[prefix + "/seg"], dtype=torch.int32).to(dev),
            )

        log = scan_at("all_scans")
        scans = [Scan(*(x[i] for x in log)) for i in range(log.ranges.shape[0])]
        slam._all_scans = scans
        slam._scans = [scans[i] for i in range(0, len(scans), stride)][
            : int(meta["n_anchors"])
        ]

        def pose_at(key: str) -> torch.Tensor:
            return torch.as_tensor(flat[key], dtype=torch.float32).to(dev)

        slam._carry = _OdoCarry(
            ref=scan_at("carry/ref"),
            last=scan_at("carry/last"),
            ref_gpose=pose_at("carry/ref_gpose"),
            last_gpose=pose_at("carry/last_gpose"),
            prior_rel=pose_at("carry/prior_rel"),
        )
        return slam

    # -- internals ------------------------------------------------------

    def _maybe_anchor(self, scan: Scan, t: int) -> None:
        if t % self.cfg.anchor_stride == 0:
            self._scans.append(scan)
            if (
                len(self._scans) >= 8
                and (len(self._scans) % self.optimize_every) == 0
            ):
                if self.async_backend:
                    self._schedule_backend()
                else:
                    self._backend_round()
        # After the round, as a round at scan ``t`` works on the groups
        # that the scans before ``t`` complete.
        self._all_scans.append(scan)

    def _backend_round(self) -> None:
        """Init-free correlative loop closure + robust solve over the
        session so far: the SAME machinery as ``slam_offline``
        (run_correlative_rounds), driven incrementally through the shared
        :class:`..runtime.backend.IncrementalBackend`: the loop bank and
        the tried-pair matrix persist across rounds, anchors live in
        power-of-two capacity buckets, and each round spends its
        candidate budget on pairs not yet verified."""
        rebased = self._backend.round(
            self._all_scans, self._poses, self._odo_chain,
            self._weak, self._fracture,
        )
        if rebased is None:
            return
        self.n_loops = self._backend.n_loops
        self._apply_rebased(rebased, rebased.shape[0])

    # -- async backend (frontend/backend overlap) -----------------------
    # The backend round runs on ONE host worker thread against an
    # immutable snapshot of the session (per-scan records only ever
    # append, np arrays and the scans' tensors are never mutated in
    # place); the main thread applies the result at the next feed_scan and
    # extends the correction to scans that arrived while the round was in
    # flight. On a CUDA device the worker issues its round on a stream of
    # its own: on one stream the frontend's next launch would queue
    # behind everything the round has issued.

    def _schedule_backend(self) -> None:
        self.async_stats["requested"] += 1
        if self._bg_thread is not None and self._bg_thread.is_alive():
            # Single-flight with a BOUNDED backlog: fold this request
            # into one pending follow-up round launched when the
            # in-flight one completes. Plain skipping would silently
            # search fewer loops under load; queueing every request
            # would let the backlog grow without bound.
            self._pending_round = True
            self.async_stats["coalesced"] += 1
            return
        self._poll_backend()             # apply any finished result first
        self._launch_round()

    def _launch_round(self) -> None:
        snap = (
            list(self._all_scans), list(self._poses),
            list(self._odo_chain), list(self._weak), list(self._fracture),
        )
        t_snap = len(snap[1])
        on_stream = contextlib.nullcontext()
        if self.device.type == "cuda":
            if self._bg_stream is None:
                self._bg_stream = torch.cuda.Stream(self.device)
            # The snapshot's scans were written on the frontend's stream:
            # the round waits for what has been issued there so far. The
            # session keeps every scan for its whole life, so no memory
            # that the round reads is handed out again meanwhile; what
            # the round allocates belongs to its own stream, and all it
            # hands back is numpy.
            self._bg_stream.wait_event(torch.cuda.current_stream(self.device).record_event())
            on_stream = torch.cuda.stream(self._bg_stream)

        def work():
            try:
                with on_stream:
                    rebased = self._backend.round(*snap)
            except Exception as err:     # raised again on the caller's thread
                self._bg_error = err
                return
            if rebased is not None:
                self._bg_result = (rebased, t_snap)

        self.async_stats["started"] += 1
        self._bg_thread = threading.Thread(target=work, daemon=True)
        self._bg_thread.start()

    def _raise_worker_error(self) -> None:
        """A round that failed on the worker fails the caller: the next
        ``feed_scan`` or ``flush`` raises, and never goes on as if the
        round had run."""
        err, self._bg_error = self._bg_error, None
        if err is not None:
            raise RuntimeError("the backend round failed on its worker thread") from err

    def _poll_backend(self) -> None:
        self._raise_worker_error()
        res = self._bg_result
        if res is None:
            if (
                self._pending_round
                and self._bg_thread is not None
                and not self._bg_thread.is_alive()
            ):
                # The in-flight round finished without a correction;
                # honor the pending request now.
                self._pending_round = False
                self._launch_round()
            return
        self._bg_result = None
        rebased, t_snap = res
        self.n_loops = self._backend.n_loops
        self.async_stats["applied"] += 1
        self.async_stats["overlap_scans_max"] = max(
            self.async_stats["overlap_scans_max"], len(self._poses) - t_snap
        )
        self._apply_rebased(rebased, t_snap)
        if self._pending_round and not self._bg_thread.is_alive():
            self._pending_round = False
            self._launch_round()

    def flush(self, final_round: bool = True) -> None:
        """Wait for the in-flight async round (if any), apply it (plus
        the one pending follow-up, if a request was coalesced), then run
        one synchronous round over the complete session: scans fed
        while the last async round was in flight have not been searched
        for loops yet. Raises if a round failed on the worker."""
        while self._bg_thread is not None and (
            self._bg_thread.is_alive() or self._bg_result is not None
            or self._pending_round
        ):
            self._bg_thread.join()
            self._poll_backend()
        self._raise_worker_error()
        if final_round:
            self._backend_round()

    def _apply_rebased(self, rebased: np.ndarray, t_snap: int) -> None:
        """Splice an optimized trajectory back into the live session:
        scans the backend saw take its poses; scans that arrived later
        are shifted by the correction at the last snapshot pose."""
        n_now = len(self._poses)
        if n_now > t_snap:
            old_last = self._poses[t_snap - 1]
            delta = se2.np_compose(
                rebased[t_snap - 1], se2.np_inverse(old_last)
            ).astype(np.float32)
            tail = se2.np_compose(
                delta[None], np.stack(self._poses[t_snap:n_now])
            ).astype(np.float32)
            new_poses = [rebased[t] for t in range(t_snap)] + [
                tail[i] for i in range(tail.shape[0])
            ]
        else:
            new_poses = [rebased[t] for t in range(rebased.shape[0])]
        self._poses = new_poses
        full = np.stack(self._poses)
        # Rebuild the live map only when the optimization actually moved
        # poses (bigChange gate) — per-scan map cost stays O(1).
        if self._imap is not None and self._imap.needs_rebase(full):
            self._imap.rebase(full)
        # Rebase the live frontend carry.
        if self._carry is not None:
            last = torch.as_tensor(self._poses[-1], dtype=torch.float32).to(self.device)
            self._carry = self._carry._replace(
                last_gpose=last,
                ref_gpose=se2.compose(last, se2.inverse(self._carry.prior_rel)),
            )
