"""Port parity: the native runtime library of ``laser_slam_tpu_torch``
(its own copy of ``native.cpp`` and the ctypes bindings) against the JAX
package's: the ring buffer across threads, the TCP scan and pose frames,
the CoLa-A codec, and frames crossing between the two packages' sockets,
field for field. The port builds its library under ``build/native/``,
never inside the package."""

import threading
from pathlib import Path

import numpy as np
import pytest

from laser_slam_tpu.native import api as jnative
from laser_slam_tpu_torch.native import api as tnative

ROOT = Path(__file__).resolve().parents[1]


def test_build_goes_to_build_native_and_not_into_the_package():
    tnative.load()
    so = tnative.library_path()
    assert so.exists() and so.parent == ROOT / "build" / "native"
    assert so.name.startswith("libnative_") and so.suffix == ".so"
    pkg = ROOT / "laser_slam_tpu_torch" / "native"
    assert sorted(p.name for p in pkg.iterdir() if p.name != "__pycache__") == [
        "__init__.py", "api.py", "native.cpp"]
    # The source is the JAX package's, byte for byte: the wire frames are one.
    assert tnative.SOURCE.read_bytes() == (ROOT / "laser_slam_tpu" / "native" / "native.cpp").read_bytes()


def test_ring_buffer_threads():
    ring = tnative.ScanRing(capacity=8, max_beams=181)
    n_items = 100
    got = []

    def consumer():
        while len(got) < n_items:
            item = ring.pop(timeout_ms=2000)
            if item is None:
                break
            got.append(item)

    t = threading.Thread(target=consumer)
    t.start()
    for k in range(n_items):
        ring.push(np.full(181, float(k), np.float32), (k, 0, 0), stamp=k)
    t.join(timeout=5)
    # A fast producer may drop the oldest frames; what arrives is whole
    # and in order.
    assert len(got) + ring.dropped >= n_items
    ks = [int(r[0][0]) for r in got]
    assert ks == sorted(ks)
    for r, p, ts in got:
        assert np.all(r == r[0]) and p[0] == ts == r[0]
    assert ring.pop(timeout_ms=10) is None and len(ring) == 0
    ring.close()


def start_server(native):
    """A server of the package ``native`` on a free port; its one
    connection receives a frame, answers with a pose frame and closes.
    Returns ``(port, thread, result dict)``."""
    if native is tnative:
        srv = tnative.ScanServer(0)
        port = srv.port
    else:
        # The JAX server cannot report the port it bound to 0: a port
        # server finds a free one.
        probe = tnative.ScanServer(0)
        port = probe.port
        probe.close()
        srv = jnative.ScanServer(port)
    result = {}

    def backend():
        conn = srv.accept(timeout_ms=10_000)
        result["frame"] = conn.recv()
        conn.send_pose(7, (1.0, 2.0, 0.5), np.arange(6, dtype=np.float32))
        result["bytes"] = getattr(conn, "bytes_received", None)
        conn.close()
        srv.close()

    t = threading.Thread(target=backend)
    t.start()
    return port, t, result


@pytest.mark.parametrize("server_pkg,client_pkg", [
    ("port", "port"), ("port", "jax"), ("jax", "port")])
def test_scan_and_pose_frames_cross_between_the_packages(server_pkg, client_pkg):
    """A scan frame upstream and a pose frame downstream, between every
    pairing of the two packages' endpoints: every field arrives equal."""
    pkgs = {"port": tnative, "jax": jnative}
    port, t, result = start_server(pkgs[server_pkg])
    cli = pkgs[client_pkg].ScanSocket.connect("127.0.0.1", port)
    ranges = np.linspace(0.5, 10.0, 181).astype(np.float32)
    cli.send_scan(ranges, pose=(3.0, -1.0, 0.25), cov=np.ones(6), stamp=123.5)
    reply = cli.recv()
    t.join(timeout=10)
    assert cli.recv() is None                      # the server closed: end of stream
    cli.close()

    kind, r, p, c, ts = result["frame"]
    assert kind == "scan" and ts == 123.5
    np.testing.assert_array_equal(r, ranges)
    np.testing.assert_array_equal(p, np.float32([3.0, -1.0, 0.25]))
    np.testing.assert_array_equal(c, np.ones(6, np.float32))
    kind2, fid, pose2, cov2 = reply
    assert kind2 == "pose" and fid == 7
    np.testing.assert_array_equal(pose2, np.float32([1.0, 2.0, 0.5]))
    np.testing.assert_array_equal(cov2, np.arange(6, dtype=np.float32))
    if client_pkg == "port":
        assert cli.bytes_sent == tnative.SCAN_FRAME_BYTES + 4 * 181
        assert cli.bytes_received == tnative.POSE_FRAME_BYTES == 48
    if server_pkg == "port":
        assert result["bytes"] == 8 + 48 + 4 * 181


def test_server_on_port_zero_reports_its_port_and_times_out():
    srv = tnative.ScanServer(0)
    assert 0 < srv.port < 65536
    assert srv.accept(timeout_ms=50) is None       # nobody connects: no hang
    srv.close()
    with pytest.raises(ConnectionError):
        tnative.ScanSocket.connect("127.0.0.1", srv.port)


def test_cola_codec_matches_jax():
    for cmd in ("sRN LMDscandata", "sEN LMDscandata 1", "sMN SetAccessMode 03 F4724744"):
        t = tnative.cola_build(cmd)
        assert t == jnative.cola_build(cmd) and t[0] == 0x02 and t[-1] == 0x03
        assert tnative.cola_unwrap(t) == cmd.encode()
    vals = [1000, 1500, 2000, 2500, 3000]
    payload = ("sRA LMDscandata 1 1 89A27F 0 0 ... DIST1 3F800000 00000000 "
               "FFF92230 1388 5 " + " ".join(f"{v:X}" for v in vals)).encode()
    got = tnative.cola_parse_scandata(payload)
    np.testing.assert_array_equal(got, jnative.cola_parse_scandata(payload))
    np.testing.assert_allclose(got, [1.0, 1.5, 2.0, 2.5, 3.0])
    with pytest.raises(ValueError):
        tnative.cola_parse_scandata(b"sRA LMDscandata no distances")


def test_carmen_parser_matches_jax(tmp_path):
    """The C parser of either package on the same synthetic log."""
    import sys
    sys.path.insert(0, str(ROOT / "tools"))
    import synthetic_log

    ranges, gt, ts = synthetic_log.synthetic_log(n_scans=40, n_whips=0)
    path = str(tmp_path / "s.log")
    synthetic_log.write_carmen(path, ranges, gt, ts)
    got, want = tnative.parse_carmen(path), jnative.parse_carmen(path)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert got["ranges"].shape[0] == 40
