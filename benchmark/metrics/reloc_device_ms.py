"""Device time of a global relocalization per tick (ms): the kernels
launched under the program's ``pf.relocalize`` range (the free-space
sampler, the ray-cast + ICP scoring of every sample, the top ``n_keep``)."""

RANGE = "pf.relocalize"


def read(outcome, cell):
    tr = outcome.trace
    if tr is None or RANGE not in tr.range_device_s or not outcome.counters.get("ticks"):
        return None
    return 1e3 * tr.range_device_s[RANGE][1] / outcome.counters["ticks"]
