"""The control of a cell's comparison: the plain reference in bfloat16, the
next precision below the configurations' float32, put in the program's
place. Each of its numbers is printed beside the cell's limit; a limit
holds only where the control fails at least one of them on every seed.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

It runs on a CUDA card at the cell's own size and reads the program's
numbers from nothing: those come from the cell's own runs
(``benchmark/run.py``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    from benchmark import harness
    from benchmark.run import find_cell

    w = find_cell(json.loads((HERE.parent / "BENCHMARK.json").read_text()), args.workload)
    for seed in args.seeds:
        cell = harness.Cell.of(w, seed, args.seconds, False)
        t0 = time.perf_counter()
        checks = importlib.import_module(f"benchmark.drivers.{cell.mix['driver']}").control(cell)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "fails": [c.name for c in checks if not c.ok],
                          "checks": {c.name: [c.value, c.limit] for c in checks}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
