"""Serial motor / low-level controller link.

The role of the reference's SubCtrlCom stack (src/Main-Ctrl/SubCtrlCom/:
``SubCtrlCom`` command surface, ``SerialCom`` 115200-baud port with
``'@'``-prefixed query bytes and 32-byte packed motion commands,
``JetFire`` packer): differential-drive velocity commands down to the
motor controller, odometry/status queries back up.

This implementation keeps the same surface (drive/rotate/stop, clear
odometry, query odometry/status) over a pluggable byte transport — a
real serial port (termios) in deployment, an in-memory loopback in
tests — with an explicit checksummed frame codec instead of raw struct
dumps.

Frame format (both directions)::

    0xAA | cmd:u8 | len:u8 | payload[len] | sum:u8

``sum`` is the low byte of the sum of cmd, len and payload.
"""

from __future__ import annotations

import dataclasses
import struct

# Command bytes.
CMD_DRIVE = 0x01       # payload: vL, vR mm/s (i16) + lTime, rTime ms (u16)
CMD_ROTATE = 0x02      # payload: degrees (i16, 0.1 deg), rate (i16, 0.1 deg/s)
CMD_STOP = 0x03
CMD_CLEAR_ODO = 0x04   # reference: '@|' (SerialCom.cpp:10-16)
CMD_GET_ODO = 0x05     # reference: '@^'
CMD_GET_STATUS = 0x06  # reference: '@!'
CMD_ODO_REPLY = 0x85   # payload: x, y (i32 mm), theta (i32, 1e-4 rad)
CMD_STATUS_REPLY = 0x86  # payload: battery mV (u16), error code (u8)

_HDR = 0xAA


def encode_frame(cmd: int, payload: bytes = b"") -> bytes:
    if len(payload) > 255:
        raise ValueError("payload too long")
    s = (cmd + len(payload) + sum(payload)) & 0xFF
    return bytes([_HDR, cmd, len(payload)]) + payload + bytes([s])


def decode_frames(buf: bytearray) -> list[tuple[int, bytes]]:
    """Extract complete valid frames from ``buf`` (consumed in place);
    skips garbage bytes and frames with bad checksums."""
    out = []
    i = 0
    while i < len(buf):
        if buf[i] != _HDR:
            i += 1
            continue
        if i + 3 > len(buf):
            break  # incomplete header
        cmd, ln = buf[i + 1], buf[i + 2]
        end = i + 3 + ln + 1
        if end > len(buf):
            break  # incomplete frame
        payload = bytes(buf[i + 3 : i + 3 + ln])
        if (cmd + ln + sum(payload)) & 0xFF == buf[end - 1]:
            out.append((cmd, payload))
            i = end
        else:
            i += 1  # bad checksum: resync on next header byte
    del buf[:i]
    return out


class LoopbackTransport:
    """In-memory transport simulating an echo-capable controller —
    the test double for a termios port (the reference tests only on
    hardware; this is our 'fold to one process' equivalent)."""

    def __init__(self):
        self.written: list[bytes] = []
        self._rx = bytearray()

    def write(self, data: bytes) -> None:
        self.written.append(bytes(data))
        # Simulate controller replies to queries.
        for cmd, _ in decode_frames(bytearray(data)):
            if cmd == CMD_GET_ODO:
                self._rx += encode_frame(
                    CMD_ODO_REPLY, struct.pack("<iii", 1500, -230, 7854)
                )
            elif cmd == CMD_GET_STATUS:
                self._rx += encode_frame(
                    CMD_STATUS_REPLY, struct.pack("<HB", 24000, 0)
                )

    def read(self) -> bytes:
        data = bytes(self._rx)
        self._rx.clear()
        return data


class SerialTransport:
    """Raw termios serial port (115200 8N1, SerialCom.cpp:105-120)."""

    def __init__(self, device: str, baud: int = 115200):
        import termios

        self._fd = open(device, "r+b", buffering=0)
        fd = self._fd.fileno()
        attrs = termios.tcgetattr(fd)
        attrs[4] = attrs[5] = getattr(termios, f"B{baud}")
        termios.tcsetattr(fd, termios.TCSANOW, attrs)

    def write(self, data: bytes) -> None:
        self._fd.write(data)

    def read(self) -> bytes:
        return self._fd.read() or b""


@dataclasses.dataclass
class Odometry:
    x: float        # [m]
    y: float        # [m]
    theta: float    # [rad]


@dataclasses.dataclass
class Status:
    battery_mv: int
    error: int


class MotorLink:
    """SubCtrlCom-equivalent command surface over a transport."""

    def __init__(self, transport, wheel_base: float = 0.5):
        self._t = transport
        self.wheel_base = wheel_base
        self._rxbuf = bytearray()
        self.last_odometry: Odometry | None = None
        self.last_status: Status | None = None

    # -- commands (SubCtrlCom.h surface) --------------------------------

    def drive(self, v: float, omega: float, duration_ms: int = 200) -> None:
        """Unicycle (v, ω) → differential wheel speeds (SendNKJCmd)."""
        v_l = v - 0.5 * self.wheel_base * omega
        v_r = v + 0.5 * self.wheel_base * omega
        payload = struct.pack(
            "<hhHH",
            int(v_l * 1000), int(v_r * 1000), duration_ms, duration_ms,
        )
        self._t.write(encode_frame(CMD_DRIVE, payload))

    def rotate(self, degrees: float, rate_dps: float) -> None:
        payload = struct.pack("<hh", int(degrees * 10), int(rate_dps * 10))
        self._t.write(encode_frame(CMD_ROTATE, payload))

    def stop(self) -> None:
        self._t.write(encode_frame(CMD_STOP))

    def clear_odometry(self) -> None:
        self._t.write(encode_frame(CMD_CLEAR_ODO))

    def request_odometry(self) -> None:
        self._t.write(encode_frame(CMD_GET_ODO))

    def request_status(self) -> None:
        self._t.write(encode_frame(CMD_GET_STATUS))

    # -- uplink ----------------------------------------------------------

    def poll(self) -> None:
        """Drain the transport and update odometry/status."""
        self._rxbuf += self._t.read()
        for cmd, payload in decode_frames(self._rxbuf):
            if cmd == CMD_ODO_REPLY and len(payload) == 12:
                x, y, th = struct.unpack("<iii", payload)
                self.last_odometry = Odometry(x / 1000.0, y / 1000.0, th / 1e4)
            elif cmd == CMD_STATUS_REPLY and len(payload) == 3:
                mv, err = struct.unpack("<HB", payload)
                self.last_status = Status(mv, err)
