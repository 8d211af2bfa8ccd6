"""Runtime-switchable profiling: the program's spans and counters.

The reference's only timing hook is the compile-time
``PM_GENERATE_RESULTS`` ifdef writing per-iteration ``(iter, ms, pose)``
lines (src/zhpsm/ZHPolar_Match.cpp:905-911, 1682-1688) plus
commented-out ``gettimeofday`` blocks. Here profiling is a runtime
switch: one registry of named spans (``trace``) and counters (``count``).

Turning it on. The registry records while ``profiler.enable()`` is set,
or while any ``torch.profiler`` window records. Inside such a window a
span is also a ``record_function`` range of the same name, so it lies on
the profiler's timeline beside the device's kernels, nested in its
parent span; with only ``enable()`` set it opens no range. With neither,
``trace`` hands back one shared no-op context and ``count`` returns at
once.

Reading it. ``report()`` gives each span's count / total / mean / max
seconds, ``counts()`` each counter, ``summary()`` a table of the spans;
``device_trace(logdir)`` writes a window's Chrome trace (host ranges,
the program's spans among them, and the device's kernels), viewable in
Perfetto / ``chrome://tracing``. The registry keeps running aggregates,
not samples, so a long session holds constant memory; ``reset()``
clears it.

Spans synchronize nothing and read nothing from the device: a span
around a launch times its issue, a span around a fetch the host's wait.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import _profiler_enabled


_OFF = contextlib.nullcontext()       # the span of a registry that records nothing


class _Span:
    __slots__ = ("_prof", "_name", "_range", "_t0")

    def __init__(self, prof: "Profiler", name: str, window: bool):
        self._prof = prof
        self._name = name
        self._range = torch.profiler.record_function(name) if window else None

    def __enter__(self):
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        self._prof._add(self._name, seconds)
        return False


class Profiler:
    def __init__(self):
        self.enabled = False
        self._lock = threading.Lock()
        self._spans: dict[str, list] = {}      # name -> [count, total, max]
        self._counts: dict[str, int] = {}

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counts.clear()

    def trace(self, name: str):
        """A span named ``name`` around a ``with`` block."""
        window = _profiler_enabled()
        if not (self.enabled or window):
            return _OFF
        return _Span(self, name, window)

    def count(self, name: str, n: int = 1) -> None:
        """Adds ``n`` to the counter ``name``."""
        if self.enabled or _profiler_enabled():
            with self._lock:
                self._counts[name] = self._counts.get(name, 0) + int(n)

    def record(self, name: str, seconds: float) -> None:
        """Adds a span of ``seconds`` measured elsewhere."""
        if self.enabled or _profiler_enabled():
            self._add(name, seconds)

    def _add(self, name: str, seconds: float) -> None:
        with self._lock:
            acc = self._spans.get(name)
            if acc is None:
                self._spans[name] = [1, seconds, seconds]
            else:
                acc[0] += 1
                acc[1] += seconds
                acc[2] = max(acc[2], seconds)

    def report(self) -> dict[str, dict[str, float]]:
        """Per-span stats: count / total / mean / max (seconds)."""
        with self._lock:
            return {name: {"count": n, "total": total, "mean": total / n, "max": top}
                    for name, (n, total, top) in self._spans.items()}

    def counts(self) -> dict[str, int]:
        """Every counter's value."""
        with self._lock:
            return dict(self._counts)

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
        a CUDA device, device activity, with the program's spans as
        ranges) around a block and write it to ``logdir/trace.json`` in
        Chrome trace format."""
        import os

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
