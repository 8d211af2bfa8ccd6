"""Device time of pass 2's correlative re-match per replay (ms): the
kernels under the program's ``h2_score_volume_conv`` and ``h3_peak_nms``
ranges."""

RANGES = ("h2_score_volume_conv", "h3_peak_nms")


def read(outcome, cell):
    tr = outcome.trace
    if tr is None or not any(r in tr.range_device_s for r in RANGES):
        return None
    seconds = sum(tr.range_device_s[r][1] for r in RANGES if r in tr.range_device_s)
    return 1e3 * seconds / outcome.counters["replays"]
