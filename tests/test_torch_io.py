"""Port parity: ``io/`` of ``laser_slam_tpu_torch`` (image maps, RawSeed and
SICK logs, the NMEA GPS driver, the live SICK driver) against
``laser_slam_tpu``'s: ``tests/test_io.py``, ``test_gps.py`` and
``test_sick_driver.py`` on the port, each also compared with the JAX
package on the same files and the same bytes: equal arrays, equal fixes,
CoLa telegrams byte-equal, equal decoded scans. The drivers run against a
pty and a scripted fake LMS server (no hardware).

The readers and drivers are host code; equality is exact except the ENU
conversion (the same float64 arithmetic: exact too).
"""

import dataclasses
import math
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from laser_slam_tpu.io import gps as jgps
from laser_slam_tpu.io import image_map as jimg
from laser_slam_tpu.io import rawseed as jraw
from laser_slam_tpu.io import sick_driver as jsick
from laser_slam_tpu.mapping.occupancy import GridSpec2D as JSpec
from laser_slam_tpu.mapping.occupancy import OccupancyGrid as JGrid
from laser_slam_tpu.native import api as japi
from laser_slam_tpu_torch.io import gps as tgps
from laser_slam_tpu_torch.io import image_map as timg
from laser_slam_tpu_torch.io import rawseed as traw
from laser_slam_tpu_torch.io import sick_driver as tsick
from laser_slam_tpu_torch.mapping.occupancy import GridSpec2D, OccupancyGrid
from laser_slam_tpu_torch.native import api as tapi
from test_gps import GGA, RMC, _gga_at, _Pty, nmea
from test_sick_driver import FakeLMS


# -- image maps, RawSeed and SICK logs (tests/test_io.py) ---------------------


def test_gga_roundtrip():
    s = "$GPGGA,123519,4807.038,N,01131.000,E,1,08,0.9,545.4,M,46.9,M,,*47"
    fix = tgps.parse_gga(s)
    assert fix is not None
    assert abs(fix.lat - 48.1173) < 1e-3
    assert abs(fix.lon - 11.5167) < 1e-3
    assert fix.n_sats == 8
    assert dataclasses.asdict(fix) == dataclasses.asdict(jgps.parse_gga(s))
    assert tgps.parse_gga("$GPRMC,anything") is None
    assert tgps.parse_gga("$GPGGA,123519,,,,,0,00,,,M,,M,,*47") is None


def test_enu_conversion():
    e, n = tgps.latlon_to_enu(48.0001, 11.0, 48.0, 11.0)
    assert abs(n - 11.1) < 0.3 and abs(e) < 1e-6
    e2, _ = tgps.latlon_to_enu(48.0, 11.0001, 48.0, 11.0)
    assert 6.0 < e2 < 8.0  # cos(48°) scaling
    for args in [(48.0001, 11.0, 48.0, 11.0), (48.0, 11.0001, 48.0, 11.0), (-33.9, 151.2, -33.8, 151.1)]:
        assert tgps.latlon_to_enu(*args) == jgps.latlon_to_enu(*args)


def test_image_map_roundtrip(tmp_path):
    lo = np.zeros((40, 50), np.float32)
    lo[10, :] = 5.0       # wall
    lo[20:30, 5:45] = -5.0  # free room
    grid = OccupancyGrid(torch.from_numpy(lo), GridSpec2D(0, 0, 0.05, 50, 40))
    path = os.path.join(tmp_path, "map.png")
    timg.save_grid_image(grid, path)
    back = timg.grid_from_image(path, resolution=0.05, device="cpu")
    assert back.spec.width == 50 and back.spec.height == 40
    lo2 = back.log_odds.numpy()
    assert (lo2[10, :] > 0).all()
    assert (lo2[20:30, 5:45] < 0).all()
    assert lo2[0, 0] == 0.0  # unknown preserved

    # The JAX package writes the same image and reads the same grid.
    jpath = os.path.join(tmp_path, "jmap.png")
    jimg.save_grid_image(JGrid(jnp.asarray(lo), JSpec(0, 0, 0.05, 50, 40)), jpath)
    np.testing.assert_array_equal(timg.grid_to_image_array(grid),
                                  jimg.grid_to_image_array(JGrid(jnp.asarray(lo),
                                                                 JSpec(0, 0, 0.05, 50, 40))))
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    want = jimg.grid_from_image(path, resolution=0.05, origin_x=1.5, origin_y=-2.0)
    got = timg.grid_from_image(path, resolution=0.05, origin_x=1.5, origin_y=-2.0, device="cpu")
    np.testing.assert_array_equal(got.log_odds.numpy(), np.asarray(want.log_odds))
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)


def test_grid_from_image_runs_on_cuda_by_default(tmp_path, monkeypatch):
    path = os.path.join(tmp_path, "map.png")
    timg.save_grid_image(OccupancyGrid(torch.zeros(4, 5), GridSpec2D(0, 0, 0.05, 5, 4)), path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timg.grid_from_image(path)


def _write_rawseed(p, n=181, scans=3):
    with open(p, "w") as f:
        for t in range(scans):
            rs = ",".join(f"{2.0 + 0.01 * i - 0.05 * (i % 7 == 0) * 40:.3f}" for i in range(n))
            f.write(f"{1000.5 + t},{n},0,{rs}\n")
        f.write("short,line\n")


@pytest.mark.parametrize("n", [181, 361, 541])
def test_rawseed_reader(tmp_path, n):
    p = os.path.join(tmp_path, "rs.csv")
    _write_rawseed(p, n)
    ranges, ts, model = traw.read_rawseed(p)
    assert ranges.shape == (3, n)
    assert model.n_beams == n
    assert abs(ts[1] - 1001.5) < 1e-6
    jr, jts, jm = jraw.read_rawseed(p)
    np.testing.assert_array_equal(ranges, jr)
    np.testing.assert_array_equal(ts, jts)
    assert dataclasses.asdict(model) == dataclasses.asdict(jm)
    np.testing.assert_array_equal(traw.read_rawseed(p, max_scans=2)[0], jraw.read_rawseed(p, max_scans=2)[0])


def test_rawseed_reader_rejects_what_jax_rejects(tmp_path):
    p = os.path.join(tmp_path, "bad.csv")
    _write_rawseed(p, 100)
    for mod in (traw, jraw):
        with pytest.raises(ValueError, match="unknown beam count 100"):
            mod.read_rawseed(p)
    open(p, "w").close()
    for mod in (traw, jraw):
        with pytest.raises(ValueError, match="no scans"):
            mod.read_sick_log(p)


def test_sick_log_reader(tmp_path):
    p = os.path.join(tmp_path, "sick.log")
    with open(p, "w") as f:
        f.write("LMS 181 " + " ".join("3.5" for _ in range(181)) + "\n")
        f.write("LMS 170 " + " ".join(f"{0.05 * k:.2f}" for k in range(170)) + "\n")
    ranges, model = traw.read_sick_log(p)
    assert ranges.shape == (2, 181)
    assert np.allclose(ranges[0], 3.5)
    jr, jm = jraw.read_sick_log(p)
    np.testing.assert_array_equal(ranges, jr)
    assert model.name == jm.name


# -- the GPS driver (tests/test_gps.py) -----------------------------------------


def test_parse_gga_rmc_and_checksums_match_jax():
    fix = tgps.parse_gga(nmea(GGA).decode())
    assert fix is not None
    assert fix.lat == pytest.approx(48 + 7.038 / 60, abs=1e-6)
    assert fix.lon == pytest.approx(11 + 31.0 / 60, abs=1e-6)
    assert fix.quality == 1 and fix.n_sats == 8
    assert fix.timestamp == pytest.approx(12 * 3600 + 35 * 60 + 19)
    vel = tgps.parse_rmc(nmea(RMC).decode())
    assert vel is not None and vel.valid
    assert vel.speed == pytest.approx(22.4 * 0.514444, rel=1e-3)
    assert vel.course == pytest.approx(math.radians(84.4), rel=1e-6)
    good = nmea(GGA).decode()
    bad = good.replace("4807.038", "4807.039")
    assert tgps.parse_gga(bad) is None
    assert tgps.parse_rmc(nmea(RMC).decode().replace("022.4", "122.4")) is None
    for s in (good, bad, nmea(RMC).decode(), "$GPGGA,1,2*ZZ", "GPGGA,no dollar", "$GPRMC,1,V,,,,,,,"):
        assert tgps.nmea_checksum_ok(s) == jgps.nmea_checksum_ok(s)
        for parse in ("parse_gga", "parse_rmc"):
            a, b = getattr(tgps, parse)(s), getattr(jgps, parse)(s)
            assert (a is None) == (b is None)
            if a is not None:
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [int(c) for c in tgps.GpsError] == [int(c) for c in jgps.GpsError]


def _drive(mod, writes, settle_fixes):
    """Feed ``writes`` through a pty to ``mod.GpsDriver``; its fixes and
    error codes."""
    pty = _Pty()
    fixes, errors = [], []
    drv = mod.GpsDriver(pty.path, on_fix=fixes.append, on_error=errors.append, read_timeout=0.05)
    try:
        drv.start()
        assert drv.ready.wait(2.0)
        for w in writes:
            pty.write(w)
        deadline = time.monotonic() + 3.0
        while len(fixes) < settle_fixes and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        drv.stop()
        pty.close()
    return fixes, errors, drv


def test_driver_delivers_enu_fixes_over_pty():
    writes = [_gga_at("4807.000", "01131.000", "120000"), nmea(RMC.replace("123519", "120001")),
              _gga_at("4807.060", "01131.000", "120001")]
    fixes, errors, drv = _drive(tgps, writes, 2)
    assert len(fixes) >= 2
    assert fixes[0].east == pytest.approx(0.0, abs=1e-9)
    assert fixes[0].north == pytest.approx(0.0, abs=1e-9)
    e, n = tgps.latlon_to_enu(48 + 7.06 / 60, 0.0, 48 + 7.0 / 60, 0.0)
    assert fixes[1].north == pytest.approx(n, rel=1e-6)
    assert fixes[1].east == pytest.approx(0.0, abs=1e-9)
    assert fixes[1].speed == pytest.approx(22.4 * 0.514444, rel=1e-3)
    assert fixes[1].heading == pytest.approx(math.pi / 2 - math.radians(84.4), rel=1e-6)
    assert drv.n_fixes >= 2
    assert not errors
    jfixes, jerrors, _ = _drive(jgps, writes, 2)
    assert [tuple(f) for f in fixes] == [tuple(f) for f in jfixes]
    assert errors == jerrors


def test_driver_reports_no_fix_and_derived_velocity():
    writes = [_gga_at("4807.000", "01131.000", "120000", quality=0),
              _gga_at("4807.000", "01131.000", "120000"),
              _gga_at("4807.060", "01131.000", "120001")]
    fixes, errors, _ = _drive(tgps, writes, 2)
    assert int(tgps.GpsError.NO_FIX) in errors
    assert len(fixes) >= 2
    _, n = tgps.latlon_to_enu(48 + 7.06 / 60, 0.0, 48 + 7.0 / 60, 0.0)
    assert fixes[1].speed == pytest.approx(n / 1.0, rel=1e-3)
    assert fixes[1].heading == pytest.approx(math.pi / 2, rel=1e-3)
    jfixes, jerrors, _ = _drive(jgps, writes, 2)
    assert [tuple(f) for f in fixes] == [tuple(f) for f in jfixes]
    assert errors == jerrors


def test_open_failure_reports_error():
    errors = []
    drv = tgps.GpsDriver("/nonexistent/gps0", on_error=errors.append)
    stop = threading.Event()
    stop.set()
    drv.run(stop)
    assert errors == [int(tgps.GpsError.OPEN_FAILED)]


def test_fusion_wiring_gates_stale_fixes():
    from laser_slam_tpu_torch.core.scan import LMS211
    from laser_slam_tpu_torch.runtime.online import OnlineSlam

    slam = OnlineSlam(LMS211, use_fusion=True, incremental_map=False, device="cpu")
    obs = tgps.GpsObservation(t=100.0, east=4.0, north=2.0, lat=0, lon=0, speed=0.0,
                              heading=0.0, quality=1, n_sats=8)
    slam.feed_gps(obs, r=0.01)
    m1 = slam._fusion.mean.numpy().copy()
    assert m1[0] > 1.0 and m1[1] > 0.5  # pulled toward the fix

    # Same timestamp again → stale, ignored.
    shifted = obs._replace(east=-50.0)
    slam.feed_gps(shifted, r=0.01)
    np.testing.assert_allclose(m1, slam._fusion.mean.numpy())

    # Newer timestamp → consumed.
    slam.feed_gps(shifted._replace(t=101.0), r=0.01)
    assert slam._fusion.mean.numpy()[0] < m1[0]


# -- the live SICK driver (tests/test_sick_driver.py) ----------------------------


class RecordingLMS(FakeLMS):
    """The fake LMS, keeping every command it received."""

    def __init__(self, **kw):
        self.received = []
        super().__init__(**kw)

    def _handle(self, conn, cmd, served):
        self.received.append(cmd)
        return super()._handle(conn, cmd, served)


def test_cola_telegrams_are_byte_equal():
    assert tsick.SESSION_SEQUENCE == jsick.SESSION_SEQUENCE
    assert tsick.POLL_COMMAND == jsick.POLL_COMMAND
    assert [int(c) for c in tsick.SickError] == [int(c) for c in jsick.SickError]
    for cmd, _ in tsick.SESSION_SEQUENCE + ((tsick.POLL_COMMAND, ""),):
        assert tapi.cola_build(cmd) == japi.cola_build(cmd)
        assert tapi.cola_unwrap(tapi.cola_build(cmd)) == japi.cola_unwrap(japi.cola_build(cmd))


def test_session_sequence_and_poll():
    scans = {}
    for name, mod in (("port", tsick), ("jax", jsick)):
        srv = RecordingLMS()
        errors = []
        drv = mod.SickLMS("127.0.0.1", srv.port, on_error=errors.append)
        try:
            assert drv.connect()
            scan = drv.poll()
            assert scan is not None and scan.shape[0] == 181
            # hex 2000mm + 10i -> meters
            np.testing.assert_allclose(scan[0], 2.0, atol=1e-3)
            np.testing.assert_allclose(scan[180], 3.8, atol=1e-3)
            assert errors == []
            scans[name] = (scan, list(srv.received))
        finally:
            drv.stop()
            srv.close()
    np.testing.assert_array_equal(scans["port"][0], scans["jax"][0])
    assert scans["port"][1] == scans["jax"][1]


def test_login_rejected_reports_session_failed():
    srv = FakeLMS(reject_login=True)
    errors = []
    drv = tsick.SickLMS("127.0.0.1", srv.port, on_error=errors.append)
    try:
        assert not drv.connect()
        assert int(tsick.SickError.SESSION_FAILED) in errors
    finally:
        drv.stop()
        srv.close()


def test_bad_status_is_hardware_error():
    srv = FakeLMS(bad_status=True)
    errors = []
    drv = tsick.SickLMS("127.0.0.1", srv.port, on_error=errors.append)
    try:
        assert drv.connect()
        assert drv.poll() is None
        assert int(tsick.SickError.HARDWARE_ERROR) in errors
    finally:
        drv.stop()
        srv.close()


def test_reconnect_after_link_loss():
    srv = FakeLMS(fail_after=2)
    errors, scans = [], []
    drv = tsick.SickLMS("127.0.0.1", srv.port, on_scan=scans.append, on_error=errors.append,
                        poll_interval=0.01, timeout=0.5, reconnect_backoff=0.01)
    try:
        stop = threading.Event()
        t = threading.Thread(target=drv.run, args=(stop,), daemon=True)
        t.start()
        deadline = time.monotonic() + 10
        while len(scans) < 6 and time.monotonic() < deadline:
            time.sleep(0.05)
        stop.set()
        t.join(timeout=2)
        assert len(scans) >= 6          # kept scanning after the drop
        assert srv.sessions >= 2        # actually reconnected
        assert int(tsick.SickError.RECONNECTED) in errors
    finally:
        drv.stop()
        srv.close()


def test_connect_refused_reports_code():
    errors = []
    drv = tsick.SickLMS("127.0.0.1", 1, on_error=errors.append, timeout=0.3)
    assert not drv.connect()
    assert errors == [int(tsick.SickError.CONNECT_FAILED)]


def test_dual_sick_feeds_both_heads():
    srv_a, srv_b = FakeLMS(), FakeLMS()
    got_a, got_b = [], []
    dual = tsick.DualSick("127.0.0.1", srv_a.port, "127.0.0.1", srv_b.port,
                          on_scan_a=got_a.append, on_scan_b=got_b.append)
    try:
        dual.start()
        deadline = time.monotonic() + 5
        while (len(got_a) < 2 or len(got_b) < 2) and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        dual.stop()
        srv_a.close()
        srv_b.close()
    assert len(got_a) >= 2 and len(got_b) >= 2
