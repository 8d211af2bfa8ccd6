"""The cell ``fr079_icp.localize_icp`` (ray-cast + ICP localization on a
2 cm map) on the CPU at a small size, without the look for a card:

    python -m pytest -q -p no:cacheprovider benchmark/test_bench_localize_icp.py

A sound run of the program's plain path agrees with the reference
(``correct``); the same run with the ICP one iteration short, with the
nudge dropped, or with the march's simulated ranges one sample short, does
not; the control (the reference in bfloat16 in the program's place) fails
a limit; the least work of the search holds on a hand-worked case, and
both readers read it from a window's trace and counters, and nothing
where the program has no ``pf.icp`` range. On the card (``-m cuda``) the
control fails a limit at the cell's own size and both per-layer metrics
read non-null.
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

from benchmark import harness, roofline, roofline_icp, run  # noqa: E402
from benchmark.drivers import localize_icp  # noqa: E402

import laser_slam_tpu_torch.localization.particle_filter as pf  # noqa: E402
from laser_slam_tpu_torch.utils.profiling import profiler  # noqa: E402

torch.set_num_threads(1)

CELL = "fr079_icp.localize_icp"
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
WORKLOAD = run.find_cell(BENCH, CELL)
READERS = ("icp_device_ms", "icp_roofline")
# The test size: 40 scans, a coarse map and a small cloud.
N_SCANS, SECONDS = 40, 0.3
LOCALIZATION = {"particles": 24, "resolution": 0.2}
MIX = {"warmup_ticks": 1, "check_ticks": 4}


def small_cell(seed: int = 2**31 + 13, device: str = "cpu", trace: bool = False) -> harness.Cell:
    cell = harness.Cell.of(WORKLOAD, seed, SECONDS, trace, device=device, n_scans=N_SCANS,
                           t_start=time.perf_counter())
    cell.cfg["localization"].update(LOCALIZATION)
    cell.mix.update(MIX)
    return cell


def correct(outcome: harness.Outcome) -> bool:
    return all(c.ok for c in outcome.checks)


def test_sound_run_is_correct():
    out = localize_icp.run(small_cell())
    assert out.attempted > 0 and out.failed == 0
    assert correct(out), out.checks
    assert out.end_to_end["setup_s"] > 0 and out.end_to_end["localize_tick_p95_ms"] > 0


def _one_iteration_short(fn):
    def short(*args, **kwargs):
        return fn(*args, **{**kwargs, "iters": kwargs["iters"] - 1})
    return short


def _nudge_dropped(fn):
    def dropped(*args, **kwargs):
        return fn(*args, **{**kwargs, "nudge": False})
    return dropped


def _one_sample_short(fn):
    def short(grid, *args, **kwargs):
        return fn(grid, *args, **kwargs) - grid.spec.resolution
    return short


FAULTS = {"icp_one_iteration_short": ("match_icp_points", _one_iteration_short),
          "nudge_dropped": ("update_raycast_icp", _nudge_dropped),
          "march_one_sample_short": ("simulate_scan", _one_sample_short)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    attr, wrap = FAULTS[fault]
    monkeypatch.setattr(pf, attr, wrap(getattr(pf, attr)))
    out = localize_icp.run(small_cell())
    assert not correct(out), out.checks


def test_control_fails_a_limit():
    checks = localize_icp.control(small_cell())
    assert not all(c.ok for c in checks), checks


def test_least_work_hand_case():
    # Returns inside (0.1, 50) m count; 0.05 m and 51 m do not.
    ranges = np.array([[1.0, 0.05, 51.0, 49.9], [2.0, 2.0, 2.0, 2.0]])
    assert roofline_icp.scan_points(ranges, 0.1, 50.0).tolist() == [2, 4]
    # 3 particle-points against 5 simulated points, 2 iterations:
    # 2 · 3 · (5 · 8 + 77) operations.
    assert roofline_icp.search_ops(3, 5, 2) == 2 * 3 * (5 * 8 + 77)
    # 2 particles, 4 beams, 3 iterations: 3 · (2 · 4 · 9 + 4 · 9 + 2 · 24) bytes.
    assert roofline_icp.tick_bytes(2, 4, 3) == 3 * (72 + 36 + 48)


def _outcome(device_s: float | None) -> harness.Outcome:
    ranges = {} if device_s is None else {"pf.icp": (12, device_s)}
    tr = harness.TraceSummary(1.0, 0.5, 10, {}, {}, ranges, [], {})
    return harness.Outcome(attempted=3, failed=0, end_to_end={}, checks=[], trace=tr,
                           counters={"ticks": 3, "particles": 4096, "n_beams": 361,
                                     "icp_iters": 10, "particle_points": 4096 * 3 * 340})


def test_readers_hand_case():
    out = _outcome(0.24)
    assert run.read_metric("icp_device_ms", out, None) == pytest.approx(80.0)
    ops = 10 * 4096 * 3 * 340 * (361 * 8 + 77)
    n_bytes = 3 * 10 * (4096 * 361 * 9 + 361 * 9 + 4096 * 24)
    want = 100.0 * max(ops / roofline.PEAK_FP32_FLOPS, n_bytes / roofline.PEAK_BYTES_S) / 0.24
    assert run.read_metric("icp_roofline", out, None) == pytest.approx(want, rel=1e-12)


def test_program_without_the_range_reads_nothing():
    for name in READERS:
        assert run.read_metric(name, _outcome(None), None) is None, name
        assert run.read_metric(name, harness.Outcome(1, 0, {}, []), None) is None, name


def test_traced_run_counts_the_search():
    profiler.disable()
    profiler.reset()
    out = localize_icp.run(small_cell(trace=True))
    profiler.reset()
    n, p = out.counters["ticks"], LOCALIZATION["particles"]
    assert out.trace is not None and "pf.icp" in out.trace.range_device_s
    assert out.counters["pf.icp_pairs"] == n * p * 361 * 361 * 10
    assert out.counters["pf.icp_chunks"] == n
    assert out.counters["pf.raycast_rays"] == n * p * 361
    assert 0 < out.counters["particle_points"] <= n * p * 361
    assert any("pf.icp_pairs" in line for line in out.notes)


@pytest.mark.cuda
def test_control_fails_a_limit_on_the_card_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell.of(WORKLOAD, 12345, BENCH["run_seconds"], False)
    checks = localize_icp.control(cell)
    assert not all(c.ok for c in checks), checks


@pytest.mark.cuda
def test_every_metric_reads_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    profiler.disable()
    profiler.reset()
    cell = small_cell(device="cuda", trace=True)
    out = localize_icp.run(cell)
    metrics = {m: run.read_metric(m, out, cell) for m in READERS}
    profiler.reset()
    assert correct(out), out.checks
    for m, v in metrics.items():
        assert v is not None and math.isfinite(v) and v > 0, (m, v)
    assert metrics["icp_roofline"] <= 100.0
