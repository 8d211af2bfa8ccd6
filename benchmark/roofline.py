"""The table of peaks and the operations and bytes of the kernels whose
roofline share the benchmark reports.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W power limit,
dense rates: float32 outside the tensor cores and HBM3 bandwidth. A card
set below 700 W runs slower under load; its limit is printed beside the
share.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12

# Floating-point operations K1 needs per beam, transcendentals counted as
# one each: a projection (transform 12, atan2 and lift 2, pair quantities
# 8, candidate bins 6, ~2 covered bins × 6), one shift of the orientation
# search (subtract, abs, two adds), the translation sums, the error-index
# sums. A solver iteration projects twice, searches every shift once and
# estimates the translation once; each match ends with one error index.
OPS_PROJECT, OPS_SHIFT, OPS_TRANSLATE, OPS_INDEX = 40, 4, 22, 8
# Bytes a chain step writes: its pose, three flags and two iteration counts.
CHAIN_STEP_OUT_BYTES = 12 + 3 + 8


def k1_chain_ops(n_beams: int, window: int, iterations: int, matches: int) -> float:
    """Operations of K1's chain entry for ``matches`` matches that took
    ``iterations`` solver iterations in all, each with its error index."""
    shifts = 2 * window + 1
    per_iter = n_beams * (2 * OPS_PROJECT + shifts * OPS_SHIFT + OPS_TRANSLATE)
    return iterations * per_iter + matches * n_beams * (OPS_PROJECT + OPS_INDEX)


def k1_chain_bytes(n_scans: int, n_beams: int) -> float:
    """Bytes of K1's chain entry, each read or written once: every scan's
    ranges (float32), bad and pair flags (bool), the bearings (float32),
    and every step's output."""
    return n_scans * n_beams * (4 + 1 + 1) + 4 * n_beams + (n_scans - 1) * CHAIN_STEP_OUT_BYTES


def least_seconds(ops: float, n_bytes: float) -> tuple[float, str]:
    """The least time the card could take, and which of the two bounds it:
    ``(seconds, "operations" | "bytes")``."""
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, n_bytes / PEAK_BYTES_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def roofline_pct(ops: float, n_bytes: float, kernel_s: float) -> float:
    """The kernel's share of its roofline, in percent: least time over
    measured kernel time."""
    return 100.0 * least_seconds(ops, n_bytes)[0] / kernel_s
