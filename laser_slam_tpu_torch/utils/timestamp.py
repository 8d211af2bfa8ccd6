"""Timestamps (the reference's ``TTimeStamp``, src/timestamp/
timestamp.h:22-31: a uint64 of 100 ns intervals since epoch, with
now / diff / time_t conversions)."""

from __future__ import annotations

import time

TimeStamp = int  # 100 ns ticks since the Unix epoch

_TICKS_PER_SECOND = 10_000_000


def now() -> TimeStamp:
    return time.time_ns() // 100


def to_seconds(ts: TimeStamp) -> float:
    return ts / _TICKS_PER_SECOND


def from_seconds(seconds: float) -> TimeStamp:
    return int(seconds * _TICKS_PER_SECOND)


def diff_seconds(a: TimeStamp, b: TimeStamp) -> float:
    """Signed ``a - b`` in seconds."""
    return (a - b) / _TICKS_PER_SECOND
