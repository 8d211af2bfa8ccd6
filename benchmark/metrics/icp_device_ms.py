"""Device time of the ray-cast + ICP model's search per tick (ms): the
kernels launched under the program's ``pf.icp`` range (the chunk loop of
``update_raycast_icp``: every iteration's nearest-two search and
update)."""

RANGE = "pf.icp"


def read(outcome, cell):
    tr = outcome.trace
    if tr is None or RANGE not in tr.range_device_s or not outcome.counters.get("ticks"):
        return None
    return 1e3 * tr.range_device_s[RANGE][1] / outcome.counters["ticks"]
