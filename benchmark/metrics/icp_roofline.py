"""The ray-cast + ICP model's search against its roofline (%): the least
time the card could take for the window's ticks over the device time of
the kernels launched under the program's ``pf.icp`` range. The least time
counts the same work whatever implements the search: particles × each
tick's valid observed points × the simulated points × iterations, and
the clouds read once an iteration (``roofline_icp.py``)."""

from benchmark import roofline, roofline_icp

RANGE = "pf.icp"


def read(outcome, cell):
    tr = outcome.trace
    c = outcome.counters
    if tr is None or RANGE not in tr.range_device_s or not c.get("ticks"):
        return None
    seconds = tr.range_device_s[RANGE][1]
    if seconds <= 0:
        return None
    ops = roofline_icp.search_ops(c["particle_points"], c["n_beams"], c["icp_iters"])
    n_bytes = c["ticks"] * roofline_icp.tick_bytes(c["particles"], c["n_beams"], c["icp_iters"])
    return roofline.roofline_pct(ops, n_bytes, seconds)
