"""Live SICK LMS1xx driver: CoLa-A session + polling + reconnect (port of
``io/sick_driver.py``; host code over the port's native codec).

The protocol/telegram layer (STX/ETX framing, LMDscandata DIST1 parsing)
lives in :mod:`..native.api`; this module is the session state machine
of the reference's ``CSICK`` driver (src/sick_reader/CSICK.cpp):

- connect + configuration sequence ``sMN SetAccessMode`` →
  ``sWN LMPoutputRange`` → ``sWN LMDscandatacfg`` → ``sMN mEEwriteall`` →
  ``sMN Run`` (turnOn, CSICK.cpp:101-186);
- polling loop ``sRN LMDscandata`` + decode with status checking
  (doProcessSimple, CSICK.cpp:280-311);
- ``hardwareError`` surfacing and automatic reconnect with error codes
  delivered to the facade's ``report_error``.

The wire format is plain TCP; the tests drive it against a scripted fake
LMS server (no hardware needed).
"""

from __future__ import annotations

import enum
import socket
import threading
import time
from typing import Callable

import numpy as np

from ..native.api import cola_build, cola_parse_scandata, cola_unwrap

ETX = b"\x03"

# Session command sequence (CSICK::turnOn, CSICK.cpp:101-186) and the
# reply prefix each must produce. Arguments mirror the reference's
# LMS1xx configuration strings.
SESSION_SEQUENCE: tuple[tuple[str, str], ...] = (
    ("sMN SetAccessMode 03 F4724744", "sAN SetAccessMode"),   # login
    ("sWN LMPoutputRange 1 +5000 -450000 +2250000", "sWA LMPoutputRange"),
    ("sWN LMDscandatacfg 01 00 0 1 0 00 00 0 0 0 0 +1", "sWA LMDscandatacfg"),
    ("sMN mEEwriteall", "sAN mEEwriteall"),                   # store
    ("sMN Run", "sAN Run"),                                   # measurement mode
)

POLL_COMMAND = "sRN LMDscandata"


class SickError(enum.IntEnum):
    """Driver error codes delivered to ``on_error`` — the role of the
    reference's SICK reconnect / hardware codes (MainCtrl_Define.h:10-15,
    slam_v1.h:16-22)."""

    CONNECT_FAILED = 10
    SESSION_FAILED = 11     # login/config/start sequence rejected
    HARDWARE_ERROR = 12     # bad status / undecodable scan (CSICK.cpp:305)
    DATA_TIMEOUT = 13
    DISCONNECTED = 14
    RECONNECTED = 15        # informative: link re-established
    GIVE_UP = 16            # reconnect budget exhausted


class SickLMS:
    """One laser head (the reference runs two of these, A and B).

    Usage::

        drv = SickLMS("192.168.0.1", 2111,
                      on_scan=facade.feed_scan_main,
                      on_error=facade.report_error)
        drv.start()        # background polling thread
        ...
        drv.stop()
    """

    def __init__(
        self,
        host: str,
        port: int = 2111,
        on_scan: Callable[[np.ndarray], object] | None = None,
        on_error: Callable[[int], None] | None = None,
        poll_interval: float = 0.02,   # 50 Hz request rate (20 ms wait,
        #                                CSICK.cpp:292)
        timeout: float = 1.0,
        reconnect_max: int = 3,
        reconnect_backoff: float = 0.2,
    ) -> None:
        self.host = host
        self.port = port
        self.on_scan = on_scan
        self.on_error = on_error
        self.poll_interval = poll_interval
        self.timeout = timeout
        self.reconnect_max = reconnect_max
        self.reconnect_backoff = reconnect_backoff

        self._sock: socket.socket | None = None
        self._buf = b""
        self._turned_on = False
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.n_scans = 0
        self.n_errors = 0

    # -- wire helpers -----------------------------------------------------

    def _emit_error(self, code: SickError) -> None:
        self.n_errors += 1
        if self.on_error is not None:
            self.on_error(int(code))

    def _send(self, cmd: str) -> None:
        assert self._sock is not None
        self._sock.sendall(cola_build(cmd))

    def _recv_telegram(self) -> bytes | None:
        """Read until ETX; returns the unwrapped payload or None."""
        assert self._sock is not None
        deadline = time.monotonic() + self.timeout
        while ETX not in self._buf:
            if time.monotonic() > deadline:
                return None
            try:
                chunk = self._sock.recv(65536)
            except (TimeoutError, socket.timeout):
                return None
            except OSError:
                return None
            if not chunk:
                return None  # peer closed
            self._buf += chunk
        end = self._buf.index(ETX)
        telegram = self._buf[: end + 1]
        self._buf = self._buf[end + 1:]
        try:
            return cola_unwrap(telegram)
        except ValueError:
            return None

    # -- session state machine (turnOn, CSICK.cpp:101-186) -----------------

    def connect(self) -> bool:
        """TCP connect + full configuration sequence. True on success."""
        self.close_socket()
        try:
            self._sock = socket.create_connection(
                (self.host, self.port), timeout=self.timeout
            )
            self._sock.settimeout(self.timeout)
        except OSError:
            self._sock = None
            self._emit_error(SickError.CONNECT_FAILED)
            return False
        self._buf = b""

        for cmd, expect in SESSION_SEQUENCE:
            self._send(cmd)
            reply = self._recv_telegram()
            if reply is None or not reply.decode(
                "ascii", "replace"
            ).startswith(expect):
                self._emit_error(SickError.SESSION_FAILED)
                self.close_socket()
                return False
        self._turned_on = True
        return True

    # -- polling (doProcessSimple, CSICK.cpp:280-311) ----------------------

    def poll(self) -> np.ndarray | None:
        """Request + decode one scan; None on hardware error (the caller
        decides whether to reconnect)."""
        if not self._turned_on or self._sock is None:
            self._emit_error(SickError.HARDWARE_ERROR)
            return None
        try:
            self._send(POLL_COMMAND)
        except OSError:
            self._emit_error(SickError.DISCONNECTED)
            self._turned_on = False
            return None
        payload = self._recv_telegram()
        if payload is None:
            self._emit_error(SickError.DATA_TIMEOUT)
            self._turned_on = False
            return None
        text = payload.decode("ascii", "replace")
        # Reply type + device status word (decodeScan's checks,
        # CSICK.cpp:224-236: field 6 must be "0").
        parts = text.split()
        if len(parts) < 6 or parts[0] not in ("sRA", "sSN") or \
                parts[1] != "LMDscandata" or parts[5] != "0":
            self._emit_error(SickError.HARDWARE_ERROR)
            return None
        try:
            ranges = cola_parse_scandata(payload)
        except ValueError:
            self._emit_error(SickError.HARDWARE_ERROR)
            return None
        self.n_scans += 1
        return ranges

    # -- supervised loop with reconnect ------------------------------------

    def run(self, stop: threading.Event | None = None) -> None:
        """Poll until stopped; on link loss, reconnect up to
        ``reconnect_max`` times (with backoff) before giving up."""
        stop = stop or self._stop
        retries = 0
        if not self._turned_on and not self.connect():
            retries += 1
        while not stop.is_set():
            if not self._turned_on:
                if retries > self.reconnect_max:
                    self._emit_error(SickError.GIVE_UP)
                    return
                time.sleep(self.reconnect_backoff * retries)
                retries += 1
                if not self.connect():
                    continue
                self._emit_error(SickError.RECONNECTED)
            scan = self.poll()
            if scan is not None:
                retries = 0
                if self.on_scan is not None:
                    self.on_scan(scan)
                time.sleep(self.poll_interval)

    def start(self) -> None:
        """Run the polling loop in a daemon thread (the reference's
        runSick_A/runSick_B pthreads, CSICK.h:48-50)."""
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.close_socket()

    def close_socket(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
        self._turned_on = False


class DualSick:
    """Two heads (SLAM + obstacle detection) like the reference's
    dual-laser CSICK (CSICK.h:46-80): head A feeds the SLAM callback,
    head B the obstacle-detection callback."""

    def __init__(
        self,
        host_a: str,
        port_a: int,
        host_b: str,
        port_b: int,
        on_scan_a: Callable | None = None,
        on_scan_b: Callable | None = None,
        on_error: Callable[[int], None] | None = None,
    ) -> None:
        self.a = SickLMS(host_a, port_a, on_scan=on_scan_a, on_error=on_error)
        self.b = SickLMS(host_b, port_b, on_scan=on_scan_b, on_error=on_error)

    def start(self) -> None:
        self.a.start()
        self.b.start()

    def stop(self) -> None:
        self.a.stop()
        self.b.stop()
