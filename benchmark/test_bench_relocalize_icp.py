"""The cell ``fr079_reloc.relocalize_icp`` (global relocalization from free
space, scored by ray-cast + ICP on a 2 cm map) on the CPU at a small size,
without the look for a card:

    python -m pytest -q -p no:cacheprovider benchmark/test_bench_relocalize_icp.py

A sound run of the program's plain path agrees with the reference
(``correct``); the same run with the ICP one iteration short, with the
nudge dropped, or with the sampler drawing over the map's whole extent
(the port's sampler before it drew from free space), does not; the
control (the reference in bfloat16 in the program's place) fails a limit;
a configuration that states ICP settings other than the program's is
refused; the cell's per-layer metrics read finite values from a traced
window, its two readers and ``icp_roofline`` by hand on a made-up one,
and nothing where the program has no ``pf.relocalize`` or ``pf.icp``
range. On the card (``-m cuda``) the control fails a limit at the cell's
own size and every per-layer metric of the cell reads non-null.
"""

from __future__ import annotations

import json
import math
import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark import harness, roofline, run  # noqa: E402
from benchmark.drivers import relocalize_icp  # noqa: E402

import laser_slam_tpu_torch.localization.particle_filter as pf  # noqa: E402
from laser_slam_tpu_torch.utils.profiling import profiler  # noqa: E402

torch.set_num_threads(1)

CELL = "fr079_reloc.relocalize_icp"
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
WORKLOAD = run.find_cell(BENCH, CELL)
READERS = ("reloc_device_ms", "reloc_host_ms")
# Every per-layer metric of the cell: its two readers and the accepted
# ones of the layers it runs (the ICP, the march, the update's and the
# estimate's issue, the device's idle share and operations).
METRICS = {*READERS, "icp_device_ms", "icp_roofline", "raycast_device_ms", "pf_host_us.update",
           "pf_host_us.estimate", "device_idle_pct.localize", "device_ops_per_tick"}
# The test size: 30 scans, a coarse map, few samples and a small cloud.
N_SCANS, SECONDS = 30, 0.3
LOCALIZATION = {"samples": 40, "particles": 12, "resolution": 0.2}
MIX = {"warmup_ticks": 1, "check_ticks": 2}


def small_cell(seed: int = 2**31 + 17, device: str = "cpu", trace: bool = False) -> harness.Cell:
    cell = harness.Cell.of(WORKLOAD, seed, SECONDS, trace, device=device, n_scans=N_SCANS,
                           t_start=time.perf_counter())
    cell.cfg["localization"].update(LOCALIZATION)
    cell.mix.update(MIX)
    return cell


def correct(outcome: harness.Outcome) -> bool:
    return all(c.ok for c in outcome.checks)


def test_sound_run_is_correct():
    out = relocalize_icp.run(small_cell())
    assert out.attempted > 0 and out.failed == 0
    assert correct(out), out.checks
    assert out.end_to_end["setup_s"] > 0 and out.end_to_end["localize_tick_p95_ms"] > 0
    assert 0 < out.counters["free_cells"]


def _one_iteration_short(fn):
    def short(*args, **kwargs):
        return fn(*args, **{**kwargs, "iters": kwargs["iters"] - 1})
    return short


def _nudge_dropped(fn):
    def dropped(*args, **kwargs):
        return fn(*args, **{**kwargs, "nudge": False})
    return dropped


def _whole_extent(fn):
    def whole(free, spec, u):
        return torch.stack([spec.origin_x + u[:, 1] * (spec.width * spec.resolution),
                            spec.origin_y + u[:, 2] * (spec.height * spec.resolution),
                            -torch.pi + u[:, 3] * (2.0 * torch.pi)], dim=-1)
    return whole


FAULTS = {"icp_one_iteration_short": ("match_icp_points", _one_iteration_short),
          "nudge_dropped": ("update_raycast_icp", _nudge_dropped),
          "sampler_over_the_whole_extent": ("free_space_poses", _whole_extent)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_timed_path_is_not_correct(fault, monkeypatch):
    attr, wrap = FAULTS[fault]
    monkeypatch.setattr(pf, attr, wrap(getattr(pf, attr)))
    out = relocalize_icp.run(small_cell())
    assert not correct(out), out.checks


def test_control_fails_a_limit():
    checks = relocalize_icp.control(small_cell())
    assert not all(c.ok for c in checks), checks


@pytest.mark.parametrize("key,value", [("icp_iters", 9), ("icp_max_corr", 0.5),
                                       ("nudge", False)])
def test_configuration_must_state_what_the_program_runs(key, value):
    cell = small_cell()
    cell.cfg["localization"][key] = value
    with pytest.raises(ValueError, match="the program runs"):
        relocalize_icp.run(cell)


def _outcome(reloc_s: float | None, icp_s: float | None) -> harness.Outcome:
    ranges = {}
    if reloc_s is not None:
        ranges["pf.relocalize"] = (3, reloc_s)
    if icp_s is not None:
        ranges["pf.icp"] = (3, icp_s)
    tr = harness.TraceSummary(1.0, 0.5, 10, {}, {}, ranges, [], {})
    return harness.Outcome(attempted=3, failed=0, end_to_end={}, checks=[], trace=tr,
                           counters={"ticks": 3, "particles": 10_000, "n_beams": 361,
                                     "icp_iters": 10, "particle_points": 10_000 * 3 * 340})


def test_device_readers_hand_case():
    out = _outcome(0.09, 0.06)
    assert run.read_metric("reloc_device_ms", out, None) == pytest.approx(30.0)
    ops = 10 * 10_000 * 3 * 340 * (361 * 8 + 77)
    n_bytes = 3 * 10 * (10_000 * 361 * 9 + 361 * 9 + 10_000 * 24)
    want = 100.0 * max(ops / roofline.PEAK_FP32_FLOPS, n_bytes / roofline.PEAK_BYTES_S) / 0.06
    assert run.read_metric("icp_roofline", out, None) == pytest.approx(want, rel=1e-12)


def test_program_without_the_ranges_reads_nothing(monkeypatch):
    """A program without ``pf.relocalize`` (the parent) reads no device
    time, no host span and, without ``pf.icp``, no roofline; no reader
    raises."""
    from laser_slam_tpu_torch.utils import profiling

    class Bare:
        def report(self):
            return {}

    monkeypatch.setattr(profiling, "profiler", Bare())
    for name in (*READERS, "icp_roofline"):
        assert run.read_metric(name, _outcome(None, None), None) is None, name
        assert run.read_metric(name, harness.Outcome(1, 0, {}, []), None) is None, name


def test_traced_run_reads_every_metric_and_counts_the_relocalization():
    profiler.disable()
    profiler.reset()
    cell = small_cell(trace=True)
    out = relocalize_icp.run(cell)
    metrics = {m["name"]: run.read_metric(m["name"], out, cell)
               for m in run.metrics_of(BENCH, "per_layer", CELL)}
    profiler.reset()
    assert set(metrics) == METRICS
    assert out.trace is not None and "pf.relocalize" in out.trace.range_device_s
    for m in ("reloc_host_ms", "pf_host_us.update", "pf_host_us.estimate"):
        assert metrics[m] is not None and math.isfinite(metrics[m]) and metrics[m] > 0, m
    host = metrics["reloc_host_ms"]
    assert host < 1e3 * sum(out.spans["tick"]) / out.counters["ticks"]
    assert metrics["pf_host_us.update"] < 1e3 * host        # inside pf.relocalize
    n, s = out.counters["ticks"], LOCALIZATION["samples"]
    assert out.counters["pf.reloc_samples"] == n * s
    assert out.counters["pf.reloc_kept"] == n * LOCALIZATION["particles"]
    assert out.counters["pf.icp_pairs"] == n * s * 361 * 361 * 10
    assert "pf.reloc_free_cells" not in out.counters      # built in set-up
    assert any("pf.reloc_samples" in line for line in out.notes)


@pytest.mark.cuda
def test_control_fails_a_limit_on_the_card_at_the_cells_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.Cell.of(WORKLOAD, 12345, BENCH["run_seconds"], False)
    checks = relocalize_icp.control(cell)
    assert not all(c.ok for c in checks), checks


@pytest.mark.cuda
def test_every_metric_reads_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    profiler.disable()
    profiler.reset()
    cell = small_cell(device="cuda", trace=True)
    out = relocalize_icp.run(cell)
    metrics = {m["name"]: run.read_metric(m["name"], out, cell)
               for m in run.metrics_of(BENCH, "per_layer", CELL)}
    profiler.reset()
    assert correct(out), out.checks
    assert set(metrics) == METRICS
    for m, v in metrics.items():
        assert v is not None and math.isfinite(v) and v >= 0, (m, v)
    assert 0 < metrics["icp_roofline"] <= 100.0
    assert metrics["reloc_device_ms"] >= metrics["icp_device_ms"] > 0
    assert out.counters["icp.nearest_two_launches"] == 10 * out.counters["ticks"]
