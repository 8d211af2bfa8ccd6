"""Distributed SLAM over TCP: the frontend/backend process split (port of
``runtime/tcp_slam.py``).

A client runs scan-matching odometry and streams ``(pose, cov, scan)``
frames to a server that rebuilds the scans, keeps the pose graph, closes
loops and pushes corrected poses back; the frames are the native
transport's (:mod:`..native.api`), byte for byte the JAX package's, so
either package's client talks to either package's server.

The frontend steps as ``OnlineSlam.feed_scan`` does: one fused PSM launch
of two pairs and its selects a scan, one fetch, and the ±π correlative
match only for the rare scan whose two matches are both bad. The backend
drives the shared :class:`..runtime.backend.IncrementalBackend`, the
in-process online session's machinery. Pose updates flow back on a
reader thread and rebase the frontend's trajectory and its carry before
the next step. :func:`run_loopback` folds both ends into one process
over localhost.

Wire protocol: the frontend streams its RAW odometry pose (never
rebased), so the server's drift and PCM reference stays valid, and ships
the step's confidence in the frame's covariance slot: variance 0 for a
normal step, ``WEAK_STEP_VAR`` for a weak one, ``FRACTURE_STEP_VAR`` for
an unrecoverable one.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from ..core import se2
from ..core.device import resolve_device
from ..core.scan import LaserModel
from ..native.api import ScanServer, ScanSocket
from ..ops.odometry import _OdoCarry, _step_deep, _step_flagged
from ..ops.preprocess import preprocess
from .backend import IncrementalBackend
from .slam import SlamConfig

WEAK_STEP_VAR = 1.0      # [m²] variance stamped on weak / deep-fallback steps
FRACTURE_STEP_VAR = 4.0  # [m²] variance stamped on fractured steps
LOOPBACK_TIMEOUT_S = 600.0


class Frontend:
    """Client side: local odometry, scan streaming, pose rebase.

    Runs on ``device``: ``cuda`` unless the caller names another, and
    then construction raises where there is no CUDA device."""

    def __init__(self, sock: ScanSocket, model: LaserModel,
                 device: torch.device | str | None = None):
        self.device = resolve_device(device)
        self.sock = sock
        self.model = model
        self._carry: _OdoCarry | None = None
        self.poses: list[np.ndarray] = []   # corrected trajectory
        self._odo: list[np.ndarray] = []    # raw odometry chain (no rebase)
        self.weak: list[bool] = []
        self.fracture: list[bool] = []
        self.n_updates = 0                  # pose updates applied
        self._updates: queue.Queue = queue.Queue()
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        while True:
            frame = self.sock.recv()
            if frame is None:
                break
            if frame[0] == "pose":
                self._updates.put(frame)

    def feed_scan(self, ranges, stamp: float = 0.0) -> np.ndarray:
        """Steps one scan ``[N]``, streams it with the raw odometry pose;
        returns the current (corrected) pose ``[3]``."""
        r = np.asarray(ranges, np.float32)
        scan = preprocess(torch.as_tensor(r).to(self.device), self.model)
        # Pending corrections are applied BEFORE the step: the rebase
        # moves the stored poses and the live carry together, so the step
        # increment below is computed in one frame. (After the step, the
        # previous pose would be un-rebased against a rebased carry, and
        # every correction would inject a jump into the streamed chain
        # that the server's cycle checks run through.)
        self._apply_updates()
        weak = frac = False
        if self._carry is None:
            zero = torch.zeros(3, dtype=torch.float32, device=self.device)
            self._carry = _OdoCarry(ref=scan, last=scan, ref_gpose=zero, last_gpose=zero,
                                    prior_rel=zero)
            pose = odo_pose = np.zeros(3, np.float32)
        else:
            before = self._carry
            self._carry, (p, _, _, deep), psm_rel = _step_flagged(self.model, before, scan)
            out = torch.cat([p, deep[None].to(p.dtype)]).cpu().numpy()
            if out[3]:
                self._carry, (p, _, _, weak_t, frac_t) = _step_deep(self.model, before, scan, psm_rel)
                out = torch.cat([p, torch.stack([weak_t, frac_t]).to(p.dtype)]).cpu().numpy()
                weak, frac = bool(out[3]), bool(out[4])
            pose = out[:3].copy()
            # Raw chain: the step's relative, integrated without rebases.
            rel = se2.np_relative(self.poses[-1][None], pose[None])[0]
            odo_pose = se2.np_compose(self._odo[-1][None], rel[None])[0].astype(np.float32)
        self.poses.append(pose)
        self._odo.append(odo_pose)
        self.weak.append(weak)
        self.fracture.append(frac)
        var = FRACTURE_STEP_VAR if frac else (WEAK_STEP_VAR if weak else 0.0)
        cov = np.asarray([var, var, var, 0.0, 0.0, 0.0], np.float32)
        self.sock.send_scan(r, pose=odo_pose, cov=cov, stamp=stamp)
        return pose

    def _apply_updates(self) -> None:
        """Rebase on the newest backend correction: the delta between the
        anchor's old and optimized pose moves everything from the anchor
        on, and the carry with it (one batched composition)."""
        latest = None
        while not self._updates.empty():
            latest = self._updates.get_nowait()
        if latest is None or self._carry is None:
            return
        _, anchor_id, new_pose, _ = latest
        if anchor_id >= len(self.poses):
            return
        delta = se2.np_compose(np.asarray(new_pose, np.float32),
                               se2.np_inverse(self.poses[anchor_id])).astype(np.float32)
        tail = se2.np_compose(delta[None], np.stack(self.poses[anchor_id:])).astype(np.float32)
        self.poses[anchor_id:] = list(tail)
        d = torch.as_tensor(delta).to(self.device)
        self._carry = self._carry._replace(
            last_gpose=se2.compose(d, self._carry.last_gpose),
            ref_gpose=se2.compose(d, self._carry.ref_gpose),
        )
        self.n_updates += 1

    @property
    def odometry(self) -> np.ndarray:
        """The raw odometry chain ``[T, 3]`` as streamed."""
        return np.stack(self._odo) if self._odo else np.zeros((0, 3), np.float32)

    def close(self) -> None:
        self.sock.close()


class Backend:
    """Server side: collect scans, close loops, push corrections.

    Runs the shared :class:`IncrementalBackend` (bank and tried-pair
    persistence, drift-aware init-free correlative verification, robust
    solve) every ``optimize_every`` anchors, and a final round over the
    whole session when the stream ends. Runs on ``device`` as
    :class:`Frontend` does."""

    def __init__(self, conn: ScanSocket, model: LaserModel, cfg: SlamConfig = SlamConfig(),
                 optimize_every: int = 8, device: torch.device | str | None = None):
        self.conn = conn
        self.model = model
        self.cfg = cfg
        self.optimize_every = optimize_every
        self._backend = IncrementalBackend(model, cfg, device=device)
        self.device = self._backend.device
        self.n_loops_total = 0
        self.round_walls: list[float] = []   # [s] every round that returned poses
        self.poses = np.zeros((0, 3), np.float32)     # after run: the trajectory,
        self.odometry = np.zeros((0, 3), np.float32)  # the streamed raw chain,
        self.weak: list[bool] = []                    # and the streamed flags
        self.fracture: list[bool] = []
        self.n_updates_sent = 0
        self.client_gone = False      # the client closed: no more updates

    def _round(self, all_scans, poses, odo, weak, frac) -> np.ndarray | None:
        """One backend round: the rebased trajectory, or ``None`` while
        too few anchor groups are complete."""
        t0 = time.perf_counter()
        rebased = self._backend.round(all_scans, poses, odo, weak, frac)
        if rebased is not None:
            self.round_walls.append(time.perf_counter() - t0)
            self.n_loops_total = self._backend.n_loops
        return rebased

    def _send_update(self, anchor: int, poses) -> None:
        """Sends the corrected pose of ``anchor`` to the client. A client
        that has finished streaming and gone away takes no more updates;
        the session's remaining scans are still served."""
        if self.client_gone:
            return
        try:
            self.conn.send_pose(anchor, poses[anchor])
            self.n_updates_sent += 1
        except ConnectionError:
            self.client_gone = True

    def run(self, max_scans: int | None = None) -> np.ndarray:
        """Serve until the stream ends (or ``max_scans``); returns the
        anchor poses. The per-scan trajectory is left in ``poses``."""
        all_scans, poses, odo = [], [], []
        weak: list[bool] = []
        frac: list[bool] = []
        stride = self.cfg.anchor_stride
        t = n_anchors = 0
        while max_scans is None or t < max_scans:
            frame = self.conn.recv()
            if frame is None or frame[0] != "scan":
                break
            _, ranges, pose, cov, _ = frame
            all_scans.append(preprocess(torch.as_tensor(ranges).to(self.device), self.model))
            # The streamed pose is the client's RAW odometry pose: the
            # working estimate integrates its increments onto the
            # corrected tail (appending the raw pose would mix frames from
            # before and after the first round).
            odo.append(np.asarray(pose, np.float32))
            if len(odo) == 1:
                poses.append(odo[0])
            else:
                rel = se2.np_relative(odo[-2][None], odo[-1][None])[0]
                poses.append(se2.np_compose(poses[-1][None], rel[None])[0].astype(np.float32))
            var = float(np.asarray(cov).reshape(-1)[0])
            weak.append(var >= 0.5 * WEAK_STEP_VAR)
            frac.append(var >= 0.5 * (WEAK_STEP_VAR + FRACTURE_STEP_VAR))
            if t % stride == 0:
                n_anchors += 1
                if (n_anchors >= IncrementalBackend.MIN_GROUPS
                        and n_anchors % self.optimize_every == 0):
                    rebased = self._round(all_scans, poses, odo, weak, frac)
                    if rebased is not None:
                        poses = list(rebased)
                        self._send_update(((len(poses) - 1) // stride) * stride, poses)
            t += 1
        # A final round over the complete session: the scans since the
        # last round have not been searched for loops yet.
        rebased = self._round(all_scans, poses, odo, weak, frac)
        if rebased is not None:
            poses = list(rebased)
        self.weak, self.fracture = weak, frac
        self.odometry = np.stack(odo) if odo else self.odometry
        self.poses = np.stack(poses) if poses else np.zeros((0, 3), np.float32)
        return self.poses[::stride]

    @property
    def bank(self) -> dict | None:
        """The loop bank of the last round (host numpy, as
        ``run_correlative_rounds`` keeps it)."""
        return self._backend._bank


def run_loopback(
    model: LaserModel,
    ranges: np.ndarray,
    cfg: SlamConfig = SlamConfig(),
    port: int = 0,
    device: torch.device | str | None = None,
) -> tuple[np.ndarray, int]:
    """Frontend and backend in one process, speaking the real wire
    protocol over localhost. ``port=0`` lets the system pick a free port.
    Returns ``(backend trajectory [T, 3], backend loop count)``: the
    backend's trajectory carries the loop-closure corrections (the
    frontend's copy only sees the anchor updates). A failure of the
    backend's thread is raised here, as is a session that takes longer
    than ``LOOPBACK_TIMEOUT_S``."""
    server = ScanServer(port)
    result: dict = {}

    def backend_main():
        try:
            conn = server.accept(timeout_ms=int(LOOPBACK_TIMEOUT_S * 1000))
            if conn is None:
                raise TimeoutError("no frontend connected")
            be = Backend(conn, model, cfg, device=device)
            be.run(max_scans=len(ranges))
            result["poses"], result["loops"] = be.poses, be.n_loops_total
            conn.close()
        except Exception as err:         # raised again on the caller's thread
            result["error"] = err

    th = threading.Thread(target=backend_main, daemon=True)
    th.start()
    try:
        fe = Frontend(ScanSocket.connect("127.0.0.1", server.port), model, device=device)
        for r in ranges:
            fe.feed_scan(r)
        fe.close()
        th.join(timeout=LOOPBACK_TIMEOUT_S)
    finally:
        server.close()
    if th.is_alive():
        raise TimeoutError(f"the backend did not finish within {LOOPBACK_TIMEOUT_S} s")
    if "error" in result:
        raise RuntimeError("the backend failed") from result["error"]
    poses = result["poses"]
    if len(poses) == 0:
        poses = np.stack(fe.poses)
    return poses, result["loops"]
