"""K1's chain entry (``psm_chain_kernel``) against its roofline (%): the
least time the card could take for the window's replays over the
kernel's device time in the window. Operations count the solver
iterations the reference matcher took on the same logs; bytes count each
input and output once a replay (``roofline.py``)."""

from benchmark import roofline


def read(outcome, cell):
    tr = outcome.trace
    hits = [v for k, v in (tr.kernel_s.items() if tr else ()) if "psm_chain_kernel" in k]
    if not hits:
        return None
    seconds = sum(h[1] for h in hits)
    c = outcome.counters
    ops = roofline.k1_chain_ops(c["n_beams"], c["window"], c["ref_iterations"], c["ref_matches"])
    # Every replay of a cell is one log of the configuration's length.
    n_bytes = c["replays"] * roofline.k1_chain_bytes(c["scans"] // c["replays"], c["n_beams"])
    return roofline.roofline_pct(ops, n_bytes, seconds)
