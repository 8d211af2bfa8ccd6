"""NMEA GPS driver: serial read loop, parsing, ENU conversion, fusion feed
(port of ``io/gps.py``; host code, a copy of the JAX package's).

The reference's GPS driver (src/gps_reader/CGPS.{h,cpp}) opens a serial
port with termios (9600 8N1, set_speed/set_Parity CGPS.cpp:5-106), runs
a ``listenUART`` read loop parsing ``$GPGGA`` (position, fix quality,
satellite count, CGPS.cpp:173-267) and ``$GPRMC`` (speed in knots ×
0.514 → m/s, course, CGPS.cpp:269-325), converts lat/lon to local
east/north meters (``getGPSXY``, CGPS.h:41-44), and exposes staleness
checking (``checkGPS``, CGPS.cpp:399).

This module keeps the same split the SICK driver uses: a pure parsing
layer (:func:`parse_gga`, :func:`parse_rmc`, :func:`latlon_to_enu`)
plus a supervised background read loop (:class:`GpsDriver`) that
delivers :class:`GpsObservation` fixes to a callback and error codes to
``report_error`` — testable against a pty fake serial port, no hardware
needed.
"""

from __future__ import annotations

import dataclasses
import enum
import math
import os
import threading
import time
from typing import Callable, NamedTuple

EARTH_RADIUS = 6378137.0  # [m] WGS84 equatorial
KNOT = 0.514444           # [m/s] (the reference rounds to 0.514, CGPS.cpp:318)


@dataclasses.dataclass
class GpsFix:
    timestamp: float       # UTC seconds of day
    lat: float             # degrees, +N
    lon: float             # degrees, +E
    quality: int
    n_sats: int
    altitude: float


@dataclasses.dataclass
class GpsVel:
    """RMC-derived velocity (CGPS.cpp:269-325)."""

    timestamp: float       # UTC seconds of day
    speed: float           # [m/s]
    course: float          # [rad] heading east-of-north → converted to
    #                        math convention (CCW from +x/east) by the driver
    valid: bool            # RMC status field 'A'


def _dm_to_deg(dm: str, hemi: str) -> float:
    """NMEA ddmm.mmmm → decimal degrees (CGPS.cpp:243-248)."""
    v = float(dm)
    deg = int(v // 100)
    minutes = v - deg * 100
    out = deg + minutes / 60.0
    return -out if hemi in ("S", "W") else out


def nmea_checksum_ok(sentence: str) -> bool:
    """Validate ``*hh`` checksum when present (absent → accepted, like
    the reference, which never checks)."""
    s = sentence.strip()
    if "*" not in s:
        return True
    body, _, chk = s.rpartition("*")
    if not body.startswith("$") or len(chk) < 2:
        return False
    acc = 0
    for ch in body[1:]:
        acc ^= ord(ch)
    try:
        return acc == int(chk[:2], 16)
    except ValueError:
        return False


def _utc_seconds(t: str) -> float:
    return (
        float(t[0:2]) * 3600 + float(t[2:4]) * 60 + float(t[4:]) if t else 0.0
    )


def parse_gga(sentence: str) -> GpsFix | None:
    """Parse a ``$GPGGA`` sentence; returns None for other/invalid
    sentences (the reference reads GGA for position, CGPS.cpp:173-267)."""
    if not sentence.startswith("$") or "GGA" not in sentence[:7]:
        return None
    if not nmea_checksum_ok(sentence):
        return None
    body = sentence.strip().split("*")[0]
    f = body.split(",")
    if len(f) < 10 or not f[2] or not f[4]:
        return None
    try:
        return GpsFix(
            timestamp=_utc_seconds(f[1]),
            lat=_dm_to_deg(f[2], f[3]),
            lon=_dm_to_deg(f[4], f[5]),
            quality=int(f[6] or 0),
            n_sats=int(f[7] or 0),
            altitude=float(f[9] or 0.0),
        )
    except (ValueError, IndexError):
        return None


def parse_rmc(sentence: str) -> GpsVel | None:
    """Parse a ``$GPRMC`` sentence for speed/course (CGPS.cpp:269-325:
    fields 7 = speed over ground [knots], 8 = course [deg true])."""
    if not sentence.startswith("$") or "RMC" not in sentence[:7]:
        return None
    if not nmea_checksum_ok(sentence):
        return None
    body = sentence.strip().split("*")[0]
    f = body.split(",")
    if len(f) < 9:
        return None
    try:
        return GpsVel(
            timestamp=_utc_seconds(f[1]),
            speed=float(f[7] or 0.0) * KNOT,
            course=math.radians(float(f[8] or 0.0)),
            valid=f[2] == "A",
        )
    except (ValueError, IndexError):
        return None


def latlon_to_enu(lat: float, lon: float, ref_lat: float, ref_lon: float):
    """Equirectangular lat/lon → local (east, north) meters around a
    reference fix (the reference's distance tables, CGPS.h:41-44)."""
    d_lat = math.radians(lat - ref_lat)
    d_lon = math.radians(lon - ref_lon)
    north = d_lat * EARTH_RADIUS
    east = d_lon * EARTH_RADIUS * math.cos(math.radians(ref_lat))
    return east, north


class GpsError(enum.IntEnum):
    """Driver error codes delivered to ``on_error`` (the role of the
    reference's serial-loss system codes, slam_v1.h:16-22)."""

    OPEN_FAILED = 20
    READ_ERROR = 21
    NO_FIX = 22        # GGA quality 0 (checkGPS false, CGPS.cpp:399)
    STALE = 23         # no fresh fix within stale_after
    CLOSED = 24


class GpsObservation(NamedTuple):
    """One delivered fix, ready for the fusion layer."""

    t: float           # UTC seconds of day (timestamp gating key)
    east: float        # [m] ENU from the first fix
    north: float       # [m]
    lat: float
    lon: float
    speed: float       # [m/s] RMC speed when fresh, else derived from
    #                    consecutive fixes
    heading: float     # [rad] CCW from east (math convention)
    quality: int
    n_sats: int


class GpsDriver:
    """Supervised NMEA read loop over a serial device or pty.

    Usage::

        drv = GpsDriver("/dev/ttyUSB0",
                        on_fix=facade.feed_gps,
                        on_error=facade.report_error)
        drv.start()       # background thread (the reference's listenUART
        ...               #  runs on its own pthread)
        drv.stop()
    """

    def __init__(
        self,
        port: str,
        baud: int = 9600,
        on_fix: Callable[[GpsObservation], object] | None = None,
        on_error: Callable[[int], None] | None = None,
        stale_after: float = 5.0,
        read_timeout: float = 0.2,
    ) -> None:
        self.port = port
        self.baud = baud
        self.on_fix = on_fix
        self.on_error = on_error
        self.stale_after = stale_after
        self.read_timeout = read_timeout

        self._fd: int | None = None
        self._buf = b""
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self.ready = threading.Event()  # set once the port is open and
        #   configured — callers (and tests feeding a pty) can wait on
        #   it instead of racing the open's input flush
        self._ref: tuple[float, float] | None = None   # first fix lat/lon
        self._last: GpsObservation | None = None
        self._last_rmc: GpsVel | None = None
        self._last_wall = 0.0       # monotonic time of last good fix
        self.n_fixes = 0
        self.n_errors = 0

    # -- port handling (OpenDev/set_speed/set_Parity, CGPS.cpp:5-121) ------

    def _emit_error(self, code: GpsError) -> None:
        self.n_errors += 1
        if self.on_error is not None:
            self.on_error(int(code))

    def open(self) -> bool:
        try:
            self._fd = os.open(self.port, os.O_RDWR | os.O_NOCTTY)
        except OSError:
            self._fd = None
            self._emit_error(GpsError.OPEN_FAILED)
            return False
        self._configure_tty()
        self._buf = b""
        return True

    def _configure_tty(self) -> None:
        """termios 8N1 at ``baud``, raw input (the reference's
        set_speed/set_Parity); skipped when the fd is not a tty (pipes
        in tests)."""
        assert self._fd is not None
        if not os.isatty(self._fd):
            return
        import termios

        try:
            attrs = termios.tcgetattr(self._fd)
            speed = getattr(termios, f"B{self.baud}", termios.B9600)
            attrs[0] = 0                                  # iflag: raw
            attrs[1] = 0                                  # oflag
            attrs[2] = (
                termios.CS8 | termios.CREAD | termios.CLOCAL
            )                                             # cflag: 8N1
            attrs[3] = 0                                  # lflag: raw
            attrs[4] = speed                              # ispeed
            attrs[5] = speed                              # ospeed
            # VTIME in deciseconds, VMIN=0: bounded blocking read
            # (CGPS.cpp:99-100 uses VTIME=150, VMIN=0).
            attrs[6][termios.VMIN] = 0
            attrs[6][termios.VTIME] = max(
                1, int(self.read_timeout * 10)
            )
            termios.tcflush(self._fd, termios.TCIOFLUSH)
            termios.tcsetattr(self._fd, termios.TCSANOW, attrs)
        except termios.error:
            pass  # pty slaves on some kernels reject some fields

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None

    # -- staleness (checkGPS, CGPS.cpp:399) --------------------------------

    def healthy(self) -> bool:
        """True iff a quality>0 fix arrived within ``stale_after``."""
        return (
            self._last is not None
            and self._last.quality > 0
            and (time.monotonic() - self._last_wall) < self.stale_after
        )

    @property
    def last_fix(self) -> GpsObservation | None:
        return self._last

    # -- read loop (listenUART, CGPS.cpp:146-331) ---------------------------

    def _readline(self) -> str | None:
        """Next ``\\n``-terminated line, or None on timeout/error."""
        assert self._fd is not None
        deadline = time.monotonic() + self.read_timeout
        while b"\n" not in self._buf:
            if time.monotonic() > deadline:
                return None
            import select

            r, _, _ = select.select([self._fd], [], [], self.read_timeout)
            if not r:
                return None
            try:
                chunk = os.read(self._fd, 512)
            except OSError:
                self._emit_error(GpsError.READ_ERROR)
                return None
            if not chunk:
                self._emit_error(GpsError.CLOSED)
                return None
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\n")
        return line.decode("ascii", "replace")

    def _handle_gga(self, fix: GpsFix) -> None:
        if fix.quality <= 0:
            self._emit_error(GpsError.NO_FIX)
            return
        if self._ref is None:
            self._ref = (fix.lat, fix.lon)
        east, north = latlon_to_enu(fix.lat, fix.lon, *self._ref)

        # Velocity/heading: prefer a fresh RMC sentence; otherwise derive
        # from consecutive fixes (the reference only has the RMC path).
        speed, heading = 0.0, 0.0
        rmc = self._last_rmc
        if rmc is not None and rmc.valid and abs(
            rmc.timestamp - fix.timestamp
        ) <= 2.0:
            speed = rmc.speed
            # NMEA course: degrees clockwise from north → math heading
            # CCW from east.
            heading = (math.pi / 2.0) - rmc.course
        elif self._last is not None and fix.timestamp > self._last.t:
            dt = fix.timestamp - self._last.t
            de = east - self._last.east
            dn = north - self._last.north
            speed = math.hypot(de, dn) / dt
            heading = math.atan2(dn, de)

        obs = GpsObservation(
            t=fix.timestamp, east=east, north=north, lat=fix.lat,
            lon=fix.lon, speed=speed, heading=heading,
            quality=fix.quality, n_sats=fix.n_sats,
        )
        self._last = obs
        self._last_wall = time.monotonic()
        self.n_fixes += 1
        if self.on_fix is not None:
            self.on_fix(obs)

    def run(self, stop: threading.Event | None = None) -> None:
        stop = stop or self._stop
        if self._fd is None and not self.open():
            return
        self.ready.set()
        stale_reported = False
        while not stop.is_set():
            line = self._readline()
            if line is None:
                if self._fd is None:
                    return
                if (
                    self._last_wall
                    and (time.monotonic() - self._last_wall)
                    > self.stale_after
                    and not stale_reported
                ):
                    self._emit_error(GpsError.STALE)
                    stale_reported = True
                continue
            fix = parse_gga(line)
            if fix is not None:
                self._handle_gga(fix)
                stale_reported = False
                continue
            vel = parse_rmc(line)
            if vel is not None:
                self._last_rmc = vel

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self.run, daemon=True)
        self._thread.start()

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        self.close()
