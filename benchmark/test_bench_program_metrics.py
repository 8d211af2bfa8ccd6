"""The per-layer metrics read from the program's own spans and counters
(``laser_slam_tpu_torch.utils.profiling``), on each cell's traced run at
the small size of ``test_bench_cells.py``:

    python -m pytest -q -p no:cacheprovider benchmark/test_bench_program_metrics.py

On the CPU every reader of a span, a counter or the host clock gives a
finite value, and ``rematch_row_use_pct`` is the share that the window's
own calls of ``odometry_keyframe`` give. On the card (``-m cuda``) every
per-layer metric of the three cells, the device trace's too, reads
non-null.
"""

from __future__ import annotations

import importlib
import json
import math
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark import harness, run  # noqa: E402
from benchmark.test_bench_cells import SIZES, small_cell  # noqa: E402

from laser_slam_tpu_torch.utils.profiling import profiler  # noqa: E402

torch.set_num_threads(1)

BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
PF_PHASES = ("predict", "update", "resample", "estimate")


def traced_run(name: str, device: str = "cpu"):
    """The cell's ``--trace 1`` run at its test size, on a registry that
    holds that window alone, and its per-layer metrics by name."""
    cell = small_cell(name)
    cell.trace, cell.device = True, device
    profiler.disable()
    profiler.reset()
    driver = importlib.import_module(f"benchmark.drivers.{cell.mix['driver']}")
    outcome = driver.run(cell)
    metrics = {m["name"]: run.read_metric(m["name"], outcome, cell)
               for m in run.metrics_of(BENCH, "per_layer", cell.name)}
    profiler.reset()
    return cell, outcome, metrics


def host_metric(m: dict) -> bool:
    return m["source"] != "device_trace"


@pytest.mark.parametrize("name", sorted(SIZES))
def test_host_side_metrics_read_finite(name):
    _, outcome, metrics = traced_run(name)
    assert outcome.trace is not None
    for m in run.metrics_of(BENCH, "per_layer", name):
        if host_metric(m):
            v = metrics[m["name"]]
            assert v is not None and math.isfinite(v) and v >= 0, (m["name"], v)


@pytest.mark.parametrize("name", ["intel_lab.odometry", "fr079.odometry"])
def test_rematch_row_use_is_the_windows_own_share(name, monkeypatch):
    from benchmark.drivers import replay
    from laser_slam_tpu_torch.ops.odometry import odometry_keyframe

    calls = []                     # (re-matched steps, deep_chunk) inside the window

    def spy(*args, **kwargs):
        res = odometry_keyframe(*args, **kwargs)
        if torch.autograd._profiler_enabled():
            calls.append((int(res.rematched.sum()), kwargs["deep_chunk"]))
        return res

    monkeypatch.setattr(replay, "odometry_keyframe", spy)
    _, outcome, metrics = traced_run(name)
    assert len(calls) == outcome.counters["replays"]
    steps = sum(s for s, _ in calls)
    rows = sum(math.ceil(s / c) * c for s, c in calls)
    assert steps > 0
    assert metrics["rematch_row_use_pct"] == pytest.approx(100.0 * steps / rows, rel=1e-12)
    # The host's own time lies inside the benchmark's span around the call.
    per_replay = 1e3 * sum(outcome.spans["odometry"]) / outcome.counters["replays"]
    assert 0 < metrics["odometry_host_ms"] < per_replay


def test_pf_phases_fit_in_the_tick():
    _, outcome, metrics = traced_run("fr079.localize")
    phases = [metrics[f"pf_host_us.{p}"] for p in PF_PHASES]
    assert all(v > 0 for v in phases)
    tick_us = 1e6 * sum(outcome.spans["tick"]) / outcome.counters["ticks"]
    assert sum(phases) < tick_us


def test_parent_program_reads_nothing(monkeypatch):
    """A program without the registry's spans and counters (as before
    they existed) gives no value, and no reader raises."""
    from laser_slam_tpu_torch.utils import profiling

    class Bare:
        def report(self):
            return {}

    outcome = harness.Outcome(attempted=1, failed=0, end_to_end={}, checks=[],
                              counters={"replays": 1, "ticks": 1})
    monkeypatch.setattr(profiling, "profiler", Bare())
    for name in ("rematch_row_use_pct", "odometry_host_ms",
                 *(f"pf_host_us.{p}" for p in PF_PHASES)):
        assert run.read_metric(name, outcome, None) is None, name


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SIZES))
def test_every_metric_reads_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, _, metrics = traced_run(name, device="cuda")
    for m, v in metrics.items():
        assert v is not None and math.isfinite(v), (m, v)
