"""The host's own time in ``odometry_keyframe`` per replay (ms): the
program's ``odometry.keyframe`` span less its two fetches
(``odometry.flags_fetch``, where the host waits for pass 1, and
``odometry.rematch_fetch``, where it waits for pass 2), totalled over the
traced window and divided by its replays."""

from laser_slam_tpu_torch.utils.profiling import profiler


def read(outcome, cell):
    spans = profiler.report()
    if "odometry.keyframe" not in spans or not outcome.counters.get("replays"):
        return None
    seconds = spans["odometry.keyframe"]["total"] - sum(
        spans[n]["total"] for n in ("odometry.flags_fetch", "odometry.rematch_fetch")
        if n in spans)
    return 1e3 * seconds / outcome.counters["replays"]
