"""Runtime-switchable profiling.

The reference's only timing hook is the compile-time
``PM_GENERATE_RESULTS`` ifdef writing per-iteration ``(iter, ms, pose)``
lines (src/zhpsm/ZHPolar_Match.cpp:905-911, 1682-1688) plus
commented-out ``gettimeofday`` blocks. Here profiling is a runtime
switch: a global timer registry with a ``trace`` context manager, and a
bridge to ``torch.profiler`` for device traces viewable in Perfetto /
``chrome://tracing``.

Timers synchronize nothing — the caller decides what to wait for; for
device work wrap the fetch (or a ``torch.cuda.synchronize``), not the
launch.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Profiler:
    def __init__(self):
        self.enabled = False
        self._acc: dict[str, list[float]] = defaultdict(list)

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self._acc.clear()

    @contextlib.contextmanager
    def trace(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._acc[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        if self.enabled:
            self._acc[name].append(seconds)

    def report(self) -> dict[str, dict[str, float]]:
        """Per-timer stats: count / total / mean / max (seconds)."""
        out = {}
        for name, xs in self._acc.items():
            out[name] = {
                "count": len(xs),
                "total": sum(xs),
                "mean": sum(xs) / len(xs),
                "max": max(xs),
            }
        return out

    def summary(self) -> str:
        lines = []
        for name, s in sorted(
            self.report().items(), key=lambda kv: -kv[1]["total"]
        ):
            lines.append(
                f"{name:32s} n={s['count']:<6d} total={s['total']*1e3:9.1f}ms"
                f" mean={s['mean']*1e3:8.2f}ms max={s['max']*1e3:8.2f}ms"
            )
        return "\n".join(lines)

    @contextlib.contextmanager
    def device_trace(self, logdir: str):
        """Capture a ``torch.profiler`` trace (host and, where there is
        a CUDA device, device activity) around a block and write it to
        ``logdir/trace.json`` in Chrome trace format."""
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


profiler = Profiler()
trace = profiler.trace
