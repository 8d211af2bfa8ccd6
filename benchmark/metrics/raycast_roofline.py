"""The beam model's ray march against its roofline (%): the least time the
card could take for the window's ticks over the device time of the
kernels launched under the program's ``pf.raycast`` range. The least
time counts the same work whatever implements the march: each particle's
samples up to each beam's observed range, and the grid and the cloud
read once a tick (``roofline_raycast.py``)."""

from benchmark import roofline, roofline_raycast

RANGE = "pf.raycast"


def read(outcome, cell):
    tr = outcome.trace
    c = outcome.counters
    if tr is None or RANGE not in tr.range_device_s or not c.get("ticks"):
        return None
    seconds = tr.range_device_s[RANGE][1]
    if seconds <= 0:
        return None
    ops = roofline_raycast.march_ops(c["particle_samples"])
    n_bytes = c["ticks"] * roofline_raycast.tick_bytes(c["grid_cells"], c["particles"],
                                                       c["n_beams"])
    return roofline.roofline_pct(ops, n_bytes, seconds)
