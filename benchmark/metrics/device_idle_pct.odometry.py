"""Share of the traced window in which no operation ran on the device (%)."""


def read(outcome, cell):
    tr = outcome.trace
    return 100.0 * (1.0 - tr.busy_s / tr.window_s) if tr and tr.n_ops else None
