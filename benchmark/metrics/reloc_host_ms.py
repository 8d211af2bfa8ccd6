"""Host time of the program's ``pf.relocalize`` span per tick (ms), over
the traced window: the relocalization's issue, since the tick fetches
only after ``estimate``."""

from laser_slam_tpu_torch.utils.profiling import profiler


def read(outcome, cell):
    span = profiler.report().get("pf.relocalize")
    if span is None or not outcome.counters.get("ticks"):
        return None
    return 1e3 * span["total"] / outcome.counters["ticks"]
