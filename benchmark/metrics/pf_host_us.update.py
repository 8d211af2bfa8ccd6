"""Host time of the particle filter's ``pf.update`` span per tick (us),
over the traced window: the phase's issue, since the tick fetches only
after ``estimate``."""

from laser_slam_tpu_torch.utils.profiling import profiler


def read(outcome, cell):
    span = profiler.report().get("pf.update")
    if span is None or not outcome.counters.get("ticks"):
        return None
    return 1e6 * span["total"] / outcome.counters["ticks"]
