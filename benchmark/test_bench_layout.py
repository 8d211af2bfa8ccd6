"""CPU checks of the benchmark's data and arithmetic:

    python -m pytest -q -p no:cacheprovider benchmark/test_bench_layout.py

Every cell of ``BENCHMARK.json`` resolves by name to its files, names and
units keep to their alphabets, the traffic generator is the repository's
``tools/synthetic_log.py`` at 180 readings, the ATE and roofline
arithmetic hold on hand-worked cases, and no module the benchmark loads
is JAX or the JAX package (nor, on the reference's side, the program).
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from benchmark import roofline, traffic  # noqa: E402
from benchmark.reference import ate  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves_by_name(w):
    assert w["name"] == f"{w['config']}.{w['traffic']}"
    assert w["chips"] == 1
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).is_file()
    mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())
    assert importlib.util.find_spec(f"benchmark.drivers.{mix['driver']}") is not None
    limits = json.loads((HERE / "limits" / f"{w['name']}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())
    mine = [m for m in METRICS if w["name"] in m.get("workloads", [w["name"]])]
    assert any(m["name"] == "setup_s" for m in mine)
    assert any(m["name"] != "setup_s" for m in mine if m in BENCH["end_to_end"])
    layer = [m for m in mine if m in BENCH["per_layer"]]
    assert layer
    for m in layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        arrow = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        assert w["name"] in arrow.get("workloads", [w["name"]])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_names_and_units(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_names_are_unique_and_plain():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [x["name"] for x in BENCH[group]]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    for w in BENCH["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


@pytest.mark.parametrize("seed", [0, 1])
def test_generator_is_the_tool_at_180_readings(seed):
    sys.path.insert(0, str(ROOT / "tools"))
    import synthetic_log

    want = synthetic_log.synthetic_log(2672, seed)
    got = traffic.synthetic_log(2672, seed)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_generator_fr079_shape_and_padding():
    cfg = json.loads((HERE / "configs" / "fr079.json").read_text())
    log = traffic.make_log(cfg, 2**31 + 7, n_scans=30)
    assert log.ranges.shape == (30, 361) and log.ranges.dtype == np.float32
    assert np.all(log.ranges[:, 360] == 51.0)
    assert log.gt.shape == (30, 3) and np.all(np.diff(log.timestamps) > 0)
    again = traffic.make_log(cfg, 2**31 + 7, n_scans=30)
    assert np.array_equal(log.ranges, again.ranges)


def test_ate_hand_cases():
    gt = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    assert ate.ate_rmse(gt, gt) == pytest.approx(0.0, abs=1e-12)
    th = 0.7
    rot = np.array([[math.cos(th), -math.sin(th)], [math.sin(th), math.cos(th)]])
    moved = gt.copy()
    moved[:, :2] = gt[:, :2] @ rot.T + [3.0, -2.0]
    assert ate.ate_rmse(moved, gt) == pytest.approx(0.0, abs=1e-12)
    # Two points 2 m apart against two points 4 m apart on one line: the
    # best fit leaves each 1 m off.
    est = np.array([[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    ref = np.array([[-1.0, 0.0, 0.0], [3.0, 0.0, 0.0]])
    assert ate.ate_rmse(est, ref) == pytest.approx(1.0, abs=1e-12)


def test_roofline_hand_case():
    # 181 beams, window 20 (41 shifts): an iteration is 181 × (80 + 164 +
    # 22) = 48,146 operations, a match's error index 181 × 48 = 8,688.
    assert roofline.k1_chain_ops(181, 20, 10, 2) == 10 * 48146 + 2 * 8688
    assert roofline.k1_chain_bytes(3, 181) == 3 * 181 * 6 + 4 * 181 + 2 * 23
    t, by = roofline.least_seconds(67e12, 1.0)
    assert (t, by) == (1.0, "operations")
    t, by = roofline.least_seconds(1.0, 3.35e12)
    assert (t, by) == (1.0, "bytes")
    assert roofline.roofline_pct(67e9, 0.0, 2e-3) == pytest.approx(50.0)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


FORBIDDEN = {"jax", "jaxlib", "flax", "laser_slam_tpu"}


def test_benchmark_loads_neither_jax_nor_the_jax_package():
    tops = _loaded(
        "import sys, json, importlib, pathlib; sys.path.insert(0, '.');"
        "import importlib.util, benchmark.run, benchmark.control;"
        "[importlib.import_module('benchmark.drivers.' + p.stem) "
        " for p in pathlib.Path('benchmark/drivers').glob('[a-z]*.py')];"
        "specs = [importlib.util.spec_from_file_location(p.stem.replace('.', '_'), p) "
        "         for p in pathlib.Path('benchmark/metrics').glob('*.py')];"
        "[s.loader.exec_module(importlib.util.module_from_spec(s)) for s in specs];"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "laser_slam_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = _loaded(
        "import sys, json, importlib, pathlib; sys.path.insert(0, '.');"
        "[importlib.import_module('benchmark.reference.' + p.stem) "
        " for p in pathlib.Path('benchmark/reference').glob('[a-z]*.py')];"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not tops & (FORBIDDEN | {"laser_slam_tpu_torch"})
