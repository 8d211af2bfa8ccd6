"""Device time of the beam model's ray march per tick (ms): the kernels
launched under the program's ``pf.raycast`` range (the chunk loop of
``update_beam``: the march and the beam likelihood)."""

RANGE = "pf.raycast"


def read(outcome, cell):
    tr = outcome.trace
    if tr is None or RANGE not in tr.range_device_s or not outcome.counters.get("ticks"):
        return None
    return 1e3 * tr.range_device_s[RANGE][1] / outcome.counters["ticks"]
