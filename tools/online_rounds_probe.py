"""How the online session's accuracy moves with its backend rounds.

Feeds the 2672-scan synthetic log (``tools/synthetic_log.py``, seed 0)
through ``laser_slam_tpu_torch.runtime.online.OnlineSlam`` on a CUDA
device at ``SlamConfig()`` defaults and prints, against the log's ground
truth: the ATE of the raw odometry chain and of the session's trajectory,
the loops banked and used by the last solve, and how many of the used
loops are wrong (``classify_loops``: more than 0.5 m or 0.2 rad off).

    python tools/online_rounds_probe.py sync            # after every synchronous round
    python tools/online_rounds_probe.py async 3         # three async sessions: drained, flushed
    python tools/online_rounds_probe.py paced 1 0.03    # async, 30 ms of sensor time a scan

Which scans an async round sees depends on how fast the scans come, so
``async`` and ``paced`` show the spread over schedules; ``sync`` shows the
session's whole course, a round every tenth anchor.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import synthetic_log as synth  # noqa: E402
from laser_slam_tpu_torch.eval import metrics  # noqa: E402
from laser_slam_tpu_torch.eval.diagnostics import classify_loops  # noqa: E402
from laser_slam_tpu_torch.io.carmen import read_carmen  # noqa: E402
from laser_slam_tpu_torch.runtime.online import OnlineSlam  # noqa: E402


def main(argv) -> None:
    mode = argv[0] if argv else "sync"
    if mode not in ("sync", "async", "paced"):
        raise SystemExit(__doc__)
    sessions = int(argv[1]) if len(argv) > 1 else 1
    pause = float(argv[2]) if mode == "paced" and len(argv) > 2 else 0.0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic.log")
        synth.write_carmen(path, *synth.synthetic_log())
        log = read_carmen(path)
    dev = torch.device("cuda")
    gt = torch.as_tensor(log.gt_pose, dtype=torch.float32, device=dev)

    def ate_of(poses) -> float:
        p = torch.as_tensor(np.asarray(poses), dtype=torch.float32, device=dev)
        return float(metrics.ate(p, gt[: p.shape[0]]).rmse)

    def report(slam: OnlineSlam, tag: str) -> None:
        bank = slam._backend._bank
        if bank is None:
            return
        n = len(slam._backend._group_pts)
        gt_anchor = log.gt_pose[np.arange(n) * slam.cfg.anchor_stride]
        used = bank.get("used", bank["act"])
        rep = classify_loops(bank["src"], bank["dst"], bank["rel"], used, gt_anchor)
        print(f"[{tag}] scans {len(slam._poses)}: ATE odometry chain "
              f"{ate_of(np.stack(slam._odo_chain)):.4f} m, session {ate_of(slam.trajectory):.4f} m; "
              f"loops banked {int(bank['act'].sum())}, used {int(used.sum())}, of them wrong "
              f"{rep.n - rep.n_correct}", flush=True)

    for _ in range(sessions):
        slam = OnlineSlam(log.model, use_fusion=True, async_backend=mode != "sync")
        if mode == "sync":
            plain_round = slam._backend_round

            def round_and_report():
                plain_round()
                report(slam, "round")

            slam._backend_round = round_and_report
        t0 = time.perf_counter()
        for r in log.ranges:
            slam.feed_scan(r)
            if pause:
                time.sleep(pause)
        print(f"[fed] {log.n_scans} scans in {time.perf_counter() - t0:.1f}s; "
              f"async_stats {slam.async_stats}", flush=True)
        slam.flush(final_round=False)
        report(slam, "drained")
        slam.flush(final_round=True)
        report(slam, "flushed")


if __name__ == "__main__":
    main(sys.argv[1:])
