"""Runs one cell of the port's benchmark once and prints its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell ``<config>.<mix>`` of ``BENCHMARK.json`` is found by name: the
deployment in ``benchmark/configs/<config>.json``, the traffic in
``benchmark/mixes/<mix>.json`` (whose ``driver`` names the module of
``benchmark/drivers/`` that drives it), the limits of the comparison with
the reference in ``benchmark/limits/<cell>.json``, and each per-layer
metric's reader in ``benchmark/metrics/<metric>.py``.

The run makes the log from ``--seed``, sets up and warms up the program
(``laser_slam_tpu_torch``) on one CUDA card, measures for ``--seconds``,
checks what the timed path produced against the plain reference and
prints, as the last line of standard output, one JSON object: with
``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from a ``torch.profiler`` trace of the window.
The numbers compared with the reference, each beside its limit, are the
last lines of standard error and the last key of that object. It exits
non-zero without a result where there is no CUDA card, and where JAX or
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# Every build and kernel cache inside the checkout, at fixed paths.
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "laser_slam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def find_cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(bench: dict, kind: str, cell: str) -> list[dict]:
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def read_metric(name: str, outcome, cell):
    """The value of per-layer metric ``name`` from its reader
    ``metrics/<name>.py``, or None where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(outcome, cell)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        print(f"run: the cell needs {w['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2

    from benchmark import harness

    cell = harness.Cell.of(w, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    torch.cuda.reset_peak_memory_stats()
    driver = importlib.import_module(f"benchmark.drivers.{cell.mix['driver']}")
    outcome = driver.run(cell)
    setup_s = outcome.end_to_end.get("setup_s")

    found = forbidden_modules()
    if found:
        print(f"run: modules that must not load were loaded: {found}", file=sys.stderr)
        return 3

    if args.trace:
        metrics = {}
        for m in metrics_of(bench, "per_layer", cell.name):
            v = read_metric(m["name"], outcome, cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": outcome.end_to_end[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(bench, "end_to_end", cell.name)}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    result = {"correct": all(c.ok for c in outcome.checks), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": device}
    tr = outcome.trace
    if args.trace and tr is not None:
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        top = sorted(tr.kernel_s.items(), key=lambda kv: kv[1][1], reverse=True)[:10]
        result["breakdown"] = {"device_ops": [[harness.kernel_name(k), v[1]] for k, v in top],
                               "idle_gaps": [[n, s] for n, s in tr.idle_gaps[:10]]}
    result["checks"] = {c.name: [c.value, c.limit] for c in outcome.checks}

    print(f"card: {harness.power_limit()}", file=sys.stderr)
    print(f"setup_s {setup_s}", file=sys.stderr)
    for line in outcome.notes:
        print(line, file=sys.stderr)
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
