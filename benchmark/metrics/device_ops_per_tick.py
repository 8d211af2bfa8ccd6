"""Device operations per particle-filter tick in the traced window."""


def read(outcome, cell):
    tr = outcome.trace
    return tr.n_ops / outcome.counters["ticks"] if tr and tr.n_ops else None
