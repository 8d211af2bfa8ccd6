"""Share of pass 2's computed rows that re-match a flagged step (%): the
program's counters ``odometry.rematch_steps`` over
``odometry.rematch_rows`` (the steps padded to whole chunks), summed over
the traced window's replays."""

from laser_slam_tpu_torch.utils.profiling import profiler


def read(outcome, cell):
    counts = profiler.counts() if hasattr(profiler, "counts") else {}
    rows = counts.get("odometry.rematch_rows")
    if not rows:
        return None
    return 100.0 * counts.get("odometry.rematch_steps", 0) / rows
