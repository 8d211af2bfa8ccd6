"""Port parity: the distributed TCP topology of ``laser_slam_tpu_torch``
(``runtime/tcp_slam``: ``Frontend``, ``Backend``, ``run_loopback``; ``cli
serve`` / ``client``) against ``laser_slam_tpu``.

Pose updates reach a frontend asynchronously, so its own corrected
trajectory depends on timing; what the stream fixes is the raw odometry
chain the frontend sends and, from it, the backend's rounds. So the
backend's trajectory and loop count are held across the packages, with
JAX's PSM matcher injected into the port's frontend (as in
``test_torch_online.py``) so that both backends are fed the same chain up
to float round-off; the rebased trajectories went through robust solves
and are held at 5e-2. A JAX frontend also streams to the port's backend,
over the wire, and the weak and fracture flags arrive scan by scan.
"""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.core import scan as jscan
from laser_slam_tpu.native import api as jnative
from laser_slam_tpu.runtime import slam as jslam
from laser_slam_tpu.runtime import tcp_slam as jtcp
from laser_slam_tpu_torch import cli as tcli
from laser_slam_tpu_torch import interop
from laser_slam_tpu_torch.native import api as tnative
from laser_slam_tpu_torch.ops import odometry as todo
from laser_slam_tpu_torch.runtime import slam as tslam
from laser_slam_tpu_torch.runtime import tcp_slam as ttcp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import synthetic_log  # noqa: E402
# The online session's test helpers: the small configuration of
# tests/test_tcp_slam.py, JAX's matcher behind the port's interface, and
# the whip scans (a 100° turn in place and a blank frame).
from test_torch_online import jax_psm, small_cfg, whip_scans  # noqa: E402

TRAJ_ATOL = 5e-2      # [m, rad] the backend's trajectory, after robust solves
CHAIN_ATOL = 1e-3     # [m, rad] the streamed raw chain, JAX's matcher injected
LOOP_MODEL = jscan.LaserModel(**synthetic_log.BOX_LOOP_MODEL)
TLOOP_MODEL = interop.model_from_fields(dataclasses.asdict(LOOP_MODEL))


@pytest.fixture(scope="module")
def jax_loopback():
    """JAX's loopback over the 170-scan box loop. Its free-port pick binds
    and closes a socket, which another process may take meanwhile: retried."""
    ranges = synthetic_log.box_loop_scans(170)
    for attempt in range(3):
        try:
            return jtcp.run_loopback(LOOP_MODEL, ranges, small_cfg(jslam.SlamConfig))
        except OSError:
            if attempt == 2:
                raise


def test_loopback_matches_jax(jax_loopback, monkeypatch):
    want_traj, want_loops = jax_loopback
    monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
    traj, loops = ttcp.run_loopback(TLOOP_MODEL, synthetic_log.box_loop_scans(170),
                                    small_cfg(tslam.SlamConfig), device="cpu")
    assert loops == want_loops >= 1
    assert traj.shape == (170, 3) and np.isfinite(traj).all()
    np.testing.assert_allclose(traj, want_traj, atol=TRAJ_ATOL)
    gt = synthetic_log.box_loop_trajectory(170)
    assert np.linalg.norm(traj[-1, :2] - traj[0, :2] - (gt[-1, :2] - gt[0, :2])) < 1.5


def serve_port_backend(model, cfg, n_scans):
    """The port's backend on a free port of the port's server, in a
    thread. Returns ``(port, thread, result dict)``."""
    server = tnative.ScanServer(0)
    out = {}

    def main():
        try:
            conn = server.accept(timeout_ms=60_000)
            be = ttcp.Backend(conn, model, cfg, device="cpu")
            be.run(max_scans=n_scans)
            out["backend"] = be
            conn.close()
        finally:
            server.close()

    th = threading.Thread(target=main, daemon=True)
    th.start()
    return server.port, th, out


def test_jax_and_port_frontends_stream_to_the_port_backend(monkeypatch):
    """A frontend of either package streams the whip scans to the port's
    backend over the wire: the backend reads the weak and fracture flags
    scan by scan (the whip weak, the blank frame weak and a fracture,
    nothing else) and the raw odometry chain; the two chains agree (JAX's
    matcher injected into the port's frontend)."""
    scans = whip_scans()
    model = jscan.LMS211
    tmodel = interop.model_from_fields(dataclasses.asdict(model))
    flags = [i in (20, 30) for i in range(len(scans))]
    chains = {}
    for client in ("jax", "port"):
        port, th, out = serve_port_backend(tmodel, tslam.SlamConfig(), len(scans))
        if client == "jax":
            fe = jtcp.Frontend(jnative.ScanSocket.connect("127.0.0.1", port), model)
        else:
            monkeypatch.setattr(todo, "match_psm_fused", jax_psm)
            fe = ttcp.Frontend(tnative.ScanSocket.connect("127.0.0.1", port), tmodel, device="cpu")
        for r in scans:
            fe.feed_scan(r)
        fe.close()
        th.join(timeout=120)
        be = out["backend"]
        assert be.weak == flags and be.fracture == [i == 30 for i in range(len(scans))]
        assert be.poses.shape == (40, 3) and len(be.round_walls) == 0     # 4 anchors: no round
        chains[client] = np.stack(fe._odo)
        np.testing.assert_allclose(be.odometry, chains[client], atol=1e-6)   # as sent, float32
        np.testing.assert_allclose(be.poses, chains[client], atol=1e-5)      # no round: the chain
    assert fe.weak == flags and fe.fracture == be.fracture
    np.testing.assert_allclose(chains["port"], chains["jax"], atol=CHAIN_ATOL)


def test_backend_serves_on_after_the_client_left():
    """A client that streams the box loop and closes at once leaves the
    server behind with rounds to run: the server serves every scan, runs
    its rounds and the final one, and stops sending updates to nobody."""
    scans = synthetic_log.box_loop_scans(170)
    port, th, out = serve_port_backend(TLOOP_MODEL, small_cfg(tslam.SlamConfig), len(scans))
    fe = ttcp.Frontend(tnative.ScanSocket.connect("127.0.0.1", port), TLOOP_MODEL, device="cpu")
    for r in scans:
        fe.feed_scan(r)
    fe.close()
    th.join(timeout=300)
    be = out["backend"]
    assert be.poses.shape == (170, 3) and np.isfinite(be.poses).all()
    assert len(be.round_walls) == 2 and be.n_loops_total >= 1    # at anchor 16, and the final
    assert be.n_updates_sent <= 1 and (be.client_gone or be.n_updates_sent == 1)


@pytest.fixture(scope="module")
def log_file(tmp_path_factory):
    ranges, gt, ts = synthetic_log.synthetic_log(n_scans=120, n_whips=0)
    path = str(tmp_path_factory.mktemp("tcp") / "synthetic.log")
    synthetic_log.write_carmen(path, ranges, gt, ts)
    return path


def test_cli_serve_and_client_on_the_cpu(log_file, tmp_path, monkeypatch):
    """``cli serve`` and ``cli client`` with ``--device cpu``: the client
    streams 120 scans, the server runs its final round (at the small
    configuration: ``SlamConfig()`` is sized for the card; the round asked
    for at the 8th anchor finds 7 complete groups and returns nothing) and
    writes the trajectory and its diagnostics."""
    small = small_cfg(tslam.SlamConfig)
    monkeypatch.setattr(tslam, "SlamConfig", lambda: small)
    probe = tnative.ScanServer(0)
    port = probe.port
    probe.close()
    out, diag, ctraj = (str(tmp_path / n) for n in ("server.txt", "server.npz", "client.txt"))
    served = {}

    def server():
        served["run"] = tcli.main(["serve", "--port", str(port), "--timeout", "60", "--device", "cpu",
                                   "--out", out, "--diag", diag])

    th = threading.Thread(target=server, daemon=True)
    th.start()
    for _ in range(100):                    # until the server listens
        try:
            run = tcli.main(["client", log_file, "--port", str(port), "--device", "cpu",
                             "--out", ctraj])
            break
        except ConnectionError:
            th.join(timeout=0.05)
    th.join(timeout=120)
    be = served["run"].backend
    assert run.seconds.shape == (120,) and run.frontend.device == torch.device("cpu")
    assert len(be.round_walls) == 1 and served["run"].port == port
    np.testing.assert_allclose(np.loadtxt(ctraj), np.stack(run.frontend.poses), atol=1e-5)
    np.testing.assert_allclose(np.loadtxt(out), be.poses, atol=1e-5)
    d = np.load(diag)
    assert d["poses"].shape == (120, 3) and int(d["bytes_in"]) == run.frontend.sock.bytes_sent
    assert int(d["bytes_in"]) == 120 * (tnative.SCAN_FRAME_BYTES + 4 * run.log.ranges.shape[1])
    np.testing.assert_allclose(be.odometry, run.frontend.odometry, atol=1e-6)


def test_entry_points_need_cuda_unless_the_cpu_is_asked_for(log_file, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = interop.model_from_fields(dataclasses.asdict(jscan.LMS211))
    for make in (lambda **kw: ttcp.Frontend(None, model, **kw),
                 lambda **kw: ttcp.Backend(None, model, **kw)):
        for kw in ({}, {"device": "cuda:0"}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make(**kw)
    assert ttcp.Backend(None, model, device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["serve", "--port", "0", "--timeout", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["client", log_file, "--port", "1"])
