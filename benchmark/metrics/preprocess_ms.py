"""Upload and preprocess of a whole log, per replay (ms): the benchmark's
span around ``ops.preprocess.preprocess``, ended by a synchronize."""


def read(outcome, cell):
    s = outcome.spans.get("preprocess")
    return 1e3 * sum(s) / len(s) if s else None
