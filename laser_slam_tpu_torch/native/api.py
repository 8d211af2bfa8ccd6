"""ctypes bindings of the native runtime library (port of ``native/api.py``).

``native.cpp`` is built with ``g++ -O2 -shared -fPIC -pthread`` at first
use into ``build/native/`` beside the package (keyed by a hash of the
source and flags, written under a temporary name and renamed into place),
never into the package itself; a failed build raises. The typed API:

- :func:`parse_carmen` — C CARMEN log parser,
- :class:`ScanRing` — thread-safe producer/consumer scan queue,
- :class:`ScanSocket` / :class:`ScanServer` — length-prefixed TCP
  scan-frame transport (the wire protocol of ``runtime/tcp_slam``),
- :func:`cola_build` / :func:`cola_unwrap` / :func:`cola_parse_scandata`
  — SICK CoLa-A codec.

The wire frames are the C library's, byte for byte the same as the JAX
package's, so a client of either package talks to a server of the other.
ctypes releases the interpreter lock for the duration of each call.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import socket
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_name("native.cpp")
BUILD_DIR = _PKG.parent / "build" / "native"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread")

# Frame sizes on the wire: magic and payload length, then the payload.
SCAN_FRAME_BYTES = 8 + 8 + 12 + 24 + 4    # + 4 per beam
POSE_FRAME_BYTES = 8 + 4 + 12 + 24

_lock = threading.Lock()
_lib = None


class _CarmenData(ct.Structure):
    _fields_ = [
        ("n_scans", ct.c_int),
        ("n_beams", ct.c_int),
        ("ranges", ct.POINTER(ct.c_float)),
        ("poses", ct.POINTER(ct.c_float)),
        ("stamps", ct.POINTER(ct.c_double)),
        ("n_gt", ct.c_int),
        ("gt", ct.POINTER(ct.c_float)),
        ("start_rad", ct.c_float),
        ("fov_rad", ct.c_float),
        ("max_range", ct.c_float),
    ]


def library_path() -> Path:
    """Where the library for the current source and flags is built."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libnative_{digest}.so"


def _build() -> Path:
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load():
    """Load (building if needed) the native library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ct.CDLL(str(_build()))
        f32p, f64p, ip = ct.POINTER(ct.c_float), ct.POINTER(ct.c_double), ct.POINTER(ct.c_int)
        lib.carmen_parse.restype = ct.POINTER(_CarmenData)
        lib.carmen_parse.argtypes = [ct.c_char_p, ct.c_int]
        lib.carmen_free.argtypes = [ct.POINTER(_CarmenData)]
        lib.ring_create.restype = ct.c_void_p
        lib.ring_create.argtypes = [ct.c_int, ct.c_int]
        lib.ring_destroy.argtypes = [ct.c_void_p]
        lib.ring_push.argtypes = [ct.c_void_p, f32p, ct.c_int, f32p, ct.c_double]
        lib.ring_pop.argtypes = [ct.c_void_p, f32p, ip, f32p, f64p, ct.c_int]
        lib.ring_size.argtypes = [ct.c_void_p]
        lib.ring_dropped.argtypes = [ct.c_void_p]
        lib.tcp_serve.argtypes = [ct.c_int]
        lib.tcp_accept.argtypes = [ct.c_int, ct.c_int]
        lib.tcp_connect.argtypes = [ct.c_char_p, ct.c_int]
        lib.tcp_connect.restype = ct.c_int
        lib.tcp_close.argtypes = [ct.c_int]
        lib.send_scan_frame.argtypes = [ct.c_int, f32p, ct.c_int, f32p, f32p, ct.c_double]
        lib.recv_frame_type.argtypes = [ct.c_int]
        lib.recv_scan_body.argtypes = [ct.c_int, f32p, ct.c_int, ip, f32p, f32p, f64p]
        lib.send_pose_update.argtypes = [ct.c_int, ct.c_int, f32p, f32p]
        lib.recv_pose_body.argtypes = [ct.c_int, ip, f32p, f32p]
        lib.cola_build.argtypes = [ct.c_char_p, ct.c_char_p, ct.c_int]
        lib.cola_unwrap.argtypes = [ct.c_char_p, ct.c_int, ct.c_char_p, ct.c_int]
        lib.cola_parse_scandata.argtypes = [ct.c_char_p, ct.c_int, f32p, ct.c_int]
        _lib = lib
        return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ct.POINTER(ct.c_float))


def parse_carmen(path: str, max_scans: int = 0) -> dict:
    """Native CARMEN parse → dict of numpy arrays + model params."""
    lib = load()
    d = lib.carmen_parse(path.encode(), max_scans)
    if not d:
        raise IOError(f"cannot parse {path}")
    c = d.contents
    try:
        ranges = np.ctypeslib.as_array(c.ranges, shape=(c.n_scans, c.n_beams)).copy()
        poses = np.ctypeslib.as_array(c.poses, shape=(c.n_scans, 3)).copy()
        stamps = np.ctypeslib.as_array(c.stamps, shape=(c.n_scans,)).copy()
        gt = np.ctypeslib.as_array(c.gt, shape=(c.n_gt, 3)).copy()
        meta = dict(start_rad=float(c.start_rad), fov_rad=float(c.fov_rad),
                    max_range=float(c.max_range))
    finally:
        lib.carmen_free(d)
    return dict(ranges=ranges, laser_pose=poses, timestamps=stamps, gt=gt, **meta)


class ScanRing:
    """Thread-safe bounded scan queue (drops the oldest when full)."""

    def __init__(self, capacity: int = 64, max_beams: int = 541):
        self._lib = load()
        self._h = self._lib.ring_create(capacity, max_beams)
        self._max_beams = max_beams

    def push(self, ranges, pose=(0, 0, 0), stamp: float = 0.0) -> None:
        r = np.ascontiguousarray(ranges, np.float32)
        p = np.asarray(pose, np.float32)
        if self._lib.ring_push(self._h, _fp(r), len(r), _fp(p), stamp) != 0:
            raise ValueError("scan too large for ring")

    def pop(self, timeout_ms: int = 0):
        """``(ranges, pose, stamp)``, or ``None`` when nothing came in
        ``timeout_ms``."""
        r = np.empty(self._max_beams, np.float32)
        p = np.empty(3, np.float32)
        n, ts = ct.c_int(), ct.c_double()
        if self._lib.ring_pop(self._h, _fp(r), ct.byref(n), _fp(p), ct.byref(ts), timeout_ms) != 0:
            return None
        return r[: n.value].copy(), p.copy(), ts.value

    def __len__(self) -> int:
        return self._lib.ring_size(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.ring_dropped(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None


class ScanSocket:
    """One endpoint of the scan-frame protocol over a connected fd.

    ``bytes_sent`` / ``bytes_received`` count the frames' bytes on the
    wire (headers included)."""

    def __init__(self, fd: int, max_beams: int = 541):
        self._lib = load()
        self.fd = fd
        self._max_beams = max_beams
        self.bytes_sent = self.bytes_received = 0

    @classmethod
    def connect(cls, host: str, port: int, max_beams: int = 541) -> "ScanSocket":
        fd = load().tcp_connect(host.encode(), port)
        if fd < 0:
            raise ConnectionError(f"connect {host}:{port} failed")
        return cls(fd, max_beams)

    def send_scan(self, ranges, pose=(0, 0, 0), cov=None, stamp: float = 0.0) -> None:
        r = np.ascontiguousarray(ranges, np.float32)
        p = np.asarray(pose, np.float32)
        c = np.zeros(6, np.float32) if cov is None else np.asarray(cov, np.float32)
        if self._lib.send_scan_frame(self.fd, _fp(r), len(r), _fp(p), _fp(c), stamp) != 0:
            raise ConnectionError("send failed")
        self.bytes_sent += SCAN_FRAME_BYTES + 4 * len(r)

    def send_pose(self, frame_id: int, pose, cov=None) -> None:
        p = np.asarray(pose, np.float32)
        c = np.zeros(6, np.float32) if cov is None else np.asarray(cov, np.float32)
        if self._lib.send_pose_update(self.fd, frame_id, _fp(p), _fp(c)) != 0:
            raise ConnectionError("send failed")
        self.bytes_sent += POSE_FRAME_BYTES

    def recv(self):
        """The next frame: ``("scan", ranges, pose, cov, stamp)`` or
        ``("pose", id, pose, cov)``, or ``None`` at the end of the stream."""
        t = self._lib.recv_frame_type(self.fd)
        if t == 1:
            r = np.empty(self._max_beams, np.float32)
            p = np.empty(3, np.float32)
            c = np.empty(6, np.float32)
            n, ts = ct.c_int(), ct.c_double()
            if self._lib.recv_scan_body(self.fd, _fp(r), self._max_beams, ct.byref(n), _fp(p),
                                        _fp(c), ct.byref(ts)) != 0:
                return None
            self.bytes_received += SCAN_FRAME_BYTES + 4 * n.value
            return ("scan", r[: n.value].copy(), p, c, ts.value)
        if t == 2:
            p = np.empty(3, np.float32)
            c = np.empty(6, np.float32)
            fid = ct.c_int()
            if self._lib.recv_pose_body(self.fd, ct.byref(fid), _fp(p), _fp(c)) != 0:
                return None
            self.bytes_received += POSE_FRAME_BYTES
            return ("pose", fid.value, p, c)
        return None

    def close(self) -> None:
        """Shuts the connection down, then closes the fd. The shutdown
        sends the end of the stream even while another thread of this
        process is blocked in :meth:`recv` on the same fd (that read then
        returns the end of the stream too); a bare close would leave the
        socket open until that read returned."""
        if self.fd >= 0:
            with socket.socket(fileno=os.dup(self.fd)) as s:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:                # the peer is gone already
                    pass
            self._lib.tcp_close(self.fd)
            self.fd = -1


class ScanServer:
    """Listening endpoint; ``accept()`` yields a :class:`ScanSocket`.
    ``port=0`` lets the system pick a free port, read back in ``port``."""

    def __init__(self, port: int):
        self._lib = load()
        self.fd = self._lib.tcp_serve(port)
        if self.fd < 0:
            raise OSError(f"cannot listen on :{port}")
        with socket.socket(fileno=os.dup(self.fd)) as s:
            self.port = s.getsockname()[1]

    def accept(self, timeout_ms: int = 10_000) -> ScanSocket | None:
        fd = self._lib.tcp_accept(self.fd, timeout_ms)
        return ScanSocket(fd) if fd >= 0 else None

    def close(self) -> None:
        if self.fd >= 0:
            self._lib.tcp_close(self.fd)
            self.fd = -1


def cola_build(cmd: str) -> bytes:
    lib = load()
    out = ct.create_string_buffer(len(cmd) + 8)
    n = lib.cola_build(cmd.encode(), out, len(cmd) + 8)
    return out.raw[:n]


def cola_unwrap(telegram: bytes) -> bytes:
    lib = load()
    out = ct.create_string_buffer(len(telegram))
    n = lib.cola_unwrap(telegram, len(telegram), out, len(telegram))
    if n < 0:
        raise ValueError("malformed telegram")
    return out.raw[:n]


def cola_parse_scandata(payload: bytes, max_beams: int = 1024) -> np.ndarray:
    lib = load()
    out = np.empty(max_beams, np.float32)
    n = lib.cola_parse_scandata(payload, len(payload), _fp(out), max_beams)
    if n < 0:
        raise ValueError("no DIST1 section")
    return out[:n].copy()
