"""The cell ``fr079_raycast.localize_beam`` (ray-cast beam-model
localization on a 2 cm map) on the CPU at a small size, without the look
for a card:

    python -m pytest -q -p no:cacheprovider benchmark/test_bench_localize_beam.py

A sound run of the program's plain path agrees with the reference
(``correct``); the same run with the march's simulated ranges one sample
short, or with the predict step dropped, does not; the control (the
reference in bfloat16 in the program's place) fails a limit; the least
work of the march holds on a hand-worked case, and both readers read it
from a window's trace and counters, and nothing where the program has no
``pf.raycast`` range. On the card (``-m cuda``) the control fails a limit
at the cell's own size and both per-layer metrics read non-null.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark import harness, roofline, roofline_raycast, run  # noqa: E402
from benchmark.drivers import localize_beam  # noqa: E402

import laser_slam_tpu_torch.localization.particle_filter as pf  # noqa: E402
import laser_slam_tpu_torch.localization.raycast as raycast  # noqa: E402
from laser_slam_tpu_torch.utils.profiling import profiler  # noqa: E402

torch.set_num_threads(1)

CELL = "fr079_raycast.localize_beam"
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
WORKLOAD = run.find_cell(BENCH, CELL)
READERS = ("raycast_device_ms", "raycast_roofline")
# The test size: 40 scans, a coarse map and a small cloud.
N_SCANS, SECONDS = 40, 0.3
LOCALIZATION = {"particles": 48, "resolution": 0.2}
MIX = {"warmup_ticks": 1, "check_ticks": 6}


def small_cell(seed: int = 2**31 + 11, device: str = "cpu", trace: bool = False) -> harness.Cell:
    cell = harness.Cell.of(WORKLOAD, seed, SECONDS, trace, device=device, n_scans=N_SCANS,
                           t_start=time.perf_counter())
    cell.cfg["localization"].update(LOCALIZATION)
    cell.mix.update(MIX)
    return cell


def correct(outcome: harness.Outcome) -> bool:
    return all(c.ok for c in outcome.checks)


def test_sound_run_is_correct():
    out = localize_beam.run(small_cell())
    assert out.attempted > 0 and out.failed == 0
    assert correct(out), out.checks
    assert out.end_to_end["setup_s"] > 0 and out.end_to_end["localize_tick_p95_ms"] > 0


def _one_sample_short(fn):
    def short(grid, *args, **kwargs):
        return fn(grid, *args, **kwargs) - grid.spec.resolution
    return short


def _predict_dropped(fn):
    def dropped(state, *args, **kwargs):
        return state
    return dropped


FAULTS = {"march_one_sample_short": (raycast, "simulate_scan", _one_sample_short),
          "predict_dropped": (pf, "predict_with_noise", _predict_dropped)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    target, attr, wrap = FAULTS[fault]
    monkeypatch.setattr(target, attr, wrap(getattr(target, attr)))
    assert not correct(localize_beam.run(small_cell()))


def test_control_fails_a_limit():
    checks = localize_beam.control(small_cell())
    assert not all(c.ok for c in checks), checks


def test_least_work_hand_case():
    # Valid returns at 1.01 m and 2.005 m need 51 and 101 samples of 2 cm;
    # a reading below the minimum range and one past the maximum need the
    # whole ladder of int(50 / 0.02) = 2500.
    ranges = np.array([[1.01, 0.05, 60.0, 2.005], [1.01, 1.01, 1.01, 1.01]])
    got = roofline_raycast.samples_per_scan(ranges, 0.1, 50.0, 0.02)
    assert got.tolist() == [51 + 2500 + 2500 + 101, 4 * 51]
    assert roofline_raycast.ladder(50.0, 0.02) == 2500
    assert roofline_raycast.march_ops(10) == 170.0
    # 100 cells, 2 particles, 4 beams: 400 + 24 + 20 + 8 bytes.
    assert roofline_raycast.tick_bytes(100, 2, 4) == 452.0


def _outcome(device_s: float | None) -> harness.Outcome:
    ranges = {} if device_s is None else {"pf.raycast": (3, device_s)}
    tr = harness.TraceSummary(1.0, 0.5, 10, {}, {}, ranges, [], {})
    return harness.Outcome(attempted=3, failed=0, end_to_end={}, checks=[], trace=tr,
                           counters={"ticks": 3, "particles": 4096, "n_beams": 361,
                                     "particle_samples": 4096 * 3 * 90_000,
                                     "grid_cells": 31_000_000})


def test_readers_hand_case():
    out = _outcome(0.9)
    assert run.read_metric("raycast_device_ms", out, None) == pytest.approx(300.0)
    ops = 17.0 * 4096 * 3 * 90_000
    n_bytes = 3 * (4 * 31e6 + 16 * 4096 + 5 * 361)
    want = 100.0 * max(ops / roofline.PEAK_FP32_FLOPS, n_bytes / roofline.PEAK_BYTES_S) / 0.9
    assert run.read_metric("raycast_roofline", out, None) == pytest.approx(want, rel=1e-12)


def test_program_without_the_range_reads_nothing():
    for name in READERS:
        assert run.read_metric(name, _outcome(None), None) is None, name
        assert run.read_metric(name, harness.Outcome(1, 0, {}, []), None) is None, name


def test_traced_run_counts_the_march():
    profiler.disable()
    profiler.reset()
    cell = small_cell(trace=True)
    out = localize_beam.run(cell)
    profiler.reset()
    n, p = out.counters["ticks"], LOCALIZATION["particles"]
    assert out.trace is not None and "pf.raycast" in out.trace.range_device_s
    assert out.counters["pf.raycast_rays"] == n * p * 361
    assert out.counters["pf.raycast_chunks"] == n
    assert out.counters["particle_samples"] > 0
    assert any("pf.raycast_rays" in line for line in out.notes)


def _metrics_on_the_card(cell):
    profiler.disable()
    profiler.reset()
    out = localize_beam.run(cell)
    profiler.reset()
    return out, {m: run.read_metric(m, out, cell) for m in READERS}


@pytest.mark.cuda
def test_control_fails_a_limit_on_the_card_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell.of(WORKLOAD, 12345, BENCH["run_seconds"], False)
    checks = localize_beam.control(cell)
    assert not all(c.ok for c in checks), checks


@pytest.mark.cuda
def test_every_metric_reads_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out, metrics = _metrics_on_the_card(small_cell(device="cuda", trace=True))
    assert correct(out), out.checks
    for m, v in metrics.items():
        assert v is not None and math.isfinite(v) and v > 0, (m, v)
    assert metrics["raycast_roofline"] <= 100.0
