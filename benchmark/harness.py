"""What every cell's run shares: the run's context, host spans, the
reduction of a ``torch.profiler`` trace, percentiles, the card's
description and the comparison records that decide ``correct``."""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import math
import subprocess
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SPAN_PREFIX = "bench."


@dataclasses.dataclass
class Cell:
    """One run of one cell: what the command line and the data files say."""

    name: str
    cfg: dict
    mix: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    n_scans: int | None = None     # shortens the log (tests only)
    t_start: float = 0.0           # perf_counter() when the process began

    @classmethod
    def of(cls, workload: dict, seed: int, seconds: float, trace: bool, **kw) -> "Cell":
        """The cell of a ``BENCHMARK.json`` workload entry, its
        configuration, mix and limits read from their files by name."""
        return cls(name=workload["name"],
                   cfg=load_json(HERE / "configs" / f"{workload['config']}.json"),
                   mix=load_json(HERE / "mixes" / f"{workload['traffic']}.json"),
                   limits=load_json(HERE / "limits" / f"{workload['name']}.json"),
                   seed=seed, seconds=seconds, trace=trace, **kw)


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end numbers it measured on
    the host clock, what the per-layer readers read from, and the
    comparison with the reference."""

    attempted: int
    failed: int
    end_to_end: dict
    checks: list
    memory_peak_bytes: int = 0
    spans: dict = dataclasses.field(default_factory=dict)      # name -> [seconds]
    counters: dict = dataclasses.field(default_factory=dict)
    trace: "TraceSummary | None" = None
    notes: list = dataclasses.field(default_factory=list)      # lines for stderr


class Spans:
    """Host spans of the benchmark's own, by name, in seconds. With
    ``profiled`` each is also a ``record_function`` range named
    ``bench.<name>`` on the profiler's timeline, and ``sync`` ends it in
    ``torch.cuda.synchronize()``."""

    def __init__(self, profiled: bool, device: str):
        self.profiled = profiled
        self.device = device
        self.seconds: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        import torch

        rf = (torch.profiler.record_function(SPAN_PREFIX + name) if self.profiled
              else contextlib.nullcontext())
        with rf:
            t0 = time.perf_counter()
            yield
            if sync and self.device != "cpu":
                torch.cuda.synchronize()
            self.seconds.setdefault(name, []).append(time.perf_counter() - t0)


@dataclasses.dataclass
class TraceSummary:
    """The reduction of one profiled window."""

    window_s: float
    busy_s: float
    n_ops: int
    ops_by_stream: dict          # device_resource_id -> count
    kernel_s: dict               # kernel name -> (count, seconds)
    range_device_s: dict         # host range name -> (calls, device seconds)
    idle_gaps: list              # [(span name, seconds)], longest first
    stream_of: dict              # kernel name -> stream id of its first launch


def summarize(prof, window_s: float) -> TraceSummary:
    """Device operations of a profiled window, from the profiler's raw
    events: their count by stream, the union of their intervals (busy
    seconds), seconds by kernel name, the device seconds of the kernels
    launched inside each host range (a kernel's launch is found by its
    correlation id), and the longest idle gaps, each named by the
    innermost benchmark span that covers it."""
    launch = {}                      # correlation id -> (start ns, thread)
    ranges, ops = [], []
    for e in prof.profiler.kineto_results.events():
        kind = str(e.device_type())
        if kind.endswith("CPU"):
            if e.is_user_annotation():
                ranges.append((e.name(), e.start_thread_id(), e.start_ns(),
                               e.start_ns() + e.duration_ns()))
            elif e.correlation_id() not in launch or e.name().startswith("cuda"):
                launch[e.correlation_id()] = (e.start_ns(), e.start_thread_id())
        elif kind.endswith("CUDA") and e.duration_ns() > 0 and not e.is_user_annotation():
            ops.append(e)
    names = {r[0] for r in ranges}
    ops = [e for e in ops if e.name() not in names]
    ops.sort(key=lambda e: e.start_ns())
    kernel_s, by_stream, stream_of = {}, {}, {}
    busy, edge, gaps = 0.0, None, []
    for e in ops:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        c, sec = kernel_s.get(e.name(), (0, 0.0))
        kernel_s[e.name()] = (c + 1, sec + e.duration_ns() / 1e9)
        sid = e.device_resource_id()
        by_stream[sid] = by_stream.get(sid, 0) + 1
        stream_of.setdefault(e.name(), sid)
        if edge is not None and start > edge:
            gaps.append((edge, start))
        lo = start if edge is None else max(start, edge)
        busy += max(0, end - lo) / 1e9
        edge = end if edge is None else max(edge, end)
    by_range = {}
    for name, th, r0, r1 in ranges:
        by_range.setdefault((name, th), []).append((r0, r1))
    range_s = {}
    for (name, th), iv in by_range.items():
        iv.sort()
        starts = [a for a, _ in iv]
        calls, sec = range_s.get(name, (0, 0.0))
        for e in ops:
            at = launch.get(e.linked_correlation_id())
            if at is None or at[1] != th:
                continue
            k = bisect.bisect_right(starts, at[0]) - 1
            if k >= 0 and iv[k][1] >= at[0]:
                sec += e.duration_ns() / 1e9
        range_s[name] = (calls + len(iv), sec)
    spans = sorted((r0, r1, n[len(SPAN_PREFIX):]) for n, _, r0, r1 in ranges
                   if n.startswith(SPAN_PREFIX))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    named = []
    for a, b in gaps[:10]:
        mid, best = 0.5 * (a + b), "outside any span"
        for s0, s1, name in spans:      # the innermost span that covers it
            if s0 > mid:
                break
            if s1 >= mid:
                best = name
        named.append((best, (b - a) / 1e9))
    return TraceSummary(window_s, busy, len(ops), by_stream, kernel_s, range_s, named, stream_of)


@contextlib.contextmanager
def profiled(enabled: bool, device: str, out: list):
    """Profiles the block when ``enabled`` (the ``--trace 1`` run) and
    appends its :class:`TraceSummary` to ``out``."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    if device != "cpu":
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        if device != "cpu":
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    out.append(summarize(prof, window))


def kernel_name(name: str) -> str:
    """A kernel's name without its argument list and anonymous namespaces,
    cut to 120 characters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:120]


def percentile(x, q: float) -> float:
    """The ``q``-th percentile (numpy's linear interpolation)."""
    x = np.asarray(x, np.float64)
    return float(np.percentile(x, q)) if x.size else float("nan")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi unavailable: {err}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def pose_gaps(a: np.ndarray, b: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Translation [m] and wrapped rotation [rad] gaps of poses ``[..., 3]``."""
    dt = np.hypot(a[..., 0] - b[..., 0], a[..., 1] - b[..., 1])
    dr = np.abs(np.remainder(a[..., 2] - b[..., 2] + np.pi, 2 * np.pi) - np.pi)
    return dt, dr


def np_relative(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pose of ``b`` in the frame of ``a`` (float64)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    th = np.remainder(b[..., 2] - a[..., 2] + np.pi, 2 * np.pi) - np.pi
    return np.stack([c * dx + s * dy, -s * dx + c * dy, th], axis=-1)
