"""Float32 arithmetic rounded as the reference's compiled code rounds it,
on any device.

Where a float32 value decides a grid cell (a beam end point on a cell
edge, a sample of a line of sight rounded to a cell), a last-bit
difference moves it by a whole cell. Two kinds of rounding matter here:

- **Fused multiply-adds.** Inside a compiled fusion the reference
  contracts ``a * b + c`` into one fused multiply-add, rounded once, in
  the vectorized body of the loop, and not in its scalar remainder
  (:func:`fma`). Bearings ``i·dfi + fi_min`` are such a loop: the last
  five of 181 beams take the other rounding (:func:`bearings`).
- **Sine and cosine.** The JAX package on the CPU rounds float32
  ``sin``/``cos`` as the C library's ``sinf``/``cosf`` do: the argument
  is reduced by the nearest multiple of π/2 in double precision, a short
  polynomial is evaluated in double precision, and the result is rounded
  to float32. ``torch.sin`` and ``torch.cos`` round about one value in
  twenty the other way, and the card rounds differently again.
  :func:`sincos` evaluates the library's algorithm with float64 tensor
  operations: the reduction subtracts ``n·π/2`` in two parts (a 24-bit
  head, whose product with ``n`` is exact, and the rest), the polynomials
  are the library's. It is the library's own path for arguments of
  magnitude below 120 (all this package passes); the library reduces
  larger ones another way.

Both are plain float64 tensor operations, one kernel each, so the CPU
and the card give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

_HPI_INV = float.fromhex("0x1.45F306DC9C883p+23")   # 2/π · 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")         # π/2
_HPI_HEAD = float(np.float32(_HPI))
_HPI_TAIL = _HPI - _HPI_HEAD
# cos(x) ≈ C0 + C1 x² + C2 x⁴ + C3 x⁶ + C4 x⁸ and
# sin(x) ≈ x + S1 x³ + S2 x⁵ + S3 x⁷ on [-π/4, π/4].
_C = (1.0, float.fromhex("-0x1.ffffffd0c621cp-2"), float.fromhex("0x1.55553e1068f19p-5"),
      float.fromhex("-0x1.6c087e89a359dp-10"), float.fromhex("0x1.99343027bf8c3p-16"))
_S = (float.fromhex("-0x1.555545995a603p-3"), float.fromhex("0x1.1107605230bc4p-7"),
      float.fromhex("-0x1.994eb3774cf24p-13"))


# float32 lanes of the reference's compiled elementwise loops on the CPU
# (AVX2 and AVX-512 hosts alike put the remainder of 181 beams at 176).
LANES = 8


def f32(x: float) -> float:
    """A Python float rounded to float32, as a compiled constant is."""
    return float(np.float32(x))


def fma(a, b, c, loop: int | None = None) -> Tensor:
    """``a * b + c`` in float32 as the reference's compiled elementwise loop
    rounds it (tensors or floats; a float counts as the float32 constant
    it compiles to): its vectorized body fuses the multiply-add (one
    rounding; in float64 here, where the product of two float32 values is
    exact), its scalar remainder — the last ``loop % LANES`` elements of
    the row-major result — multiplies and adds (two roundings). ``loop``
    is the element count of the compiled loop that evaluates the
    expression: the result's own by default; a larger one where the
    reference computes the values inside a loop over a broadcast of them."""
    a, b, c = (x if isinstance(x, Tensor) else f32(x) for x in (a, b, c))
    wide = [x.to(torch.float64) if isinstance(x, Tensor) else x for x in (a, b, c)]
    fused = (wide[0] * wide[1] + wide[2]).to(torch.float32)
    n = fused.numel()
    loop = n if loop is None else loop
    if loop % LANES == 0:
        return fused
    if loop != n:
        raise ValueError(f"a loop of {loop} elements does not evaluate a result of {n}")
    narrow = [x.to(torch.float32) if isinstance(x, Tensor) else x for x in (a, b, c)]
    plain = narrow[0] * narrow[1] + narrow[2]
    place = torch.arange(n, device=fused.device).reshape(fused.shape)
    return torch.where(place >= n - n % LANES, plain, fused)


def bearings(model, device=None, loop: int | None = None) -> Tensor:
    """``[N]`` float32 beam bearings ``i·dfi + fi_min`` as the compiled
    loop of ``loop`` elements (default ``N``) computes them (:func:`fma`)."""
    i = torch.arange(model.n_beams, dtype=torch.float64, device=device)
    return fma(i, model.dfi, model.fi_min, loop)


def linspace01(n: int, device=None) -> Tensor:
    """``n`` float32 points from 0 to 1 with the reference's arithmetic:
    ``iota(n - 1) · (1/(n - 1))`` (the float32 reciprocal), then the end
    point 1. ``torch.linspace`` rounds some of them the other way (30 of
    64, 18 of 200)."""
    if n == 1:
        return torch.zeros(1, device=device)
    s = torch.arange(n - 1, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(n - 1))
    return torch.cat([s, torch.ones(1, device=device)])


def sincos(y: Tensor) -> tuple[Tensor, Tensor]:
    """``(sin(y), cos(y))`` of a float32 tensor, each rounded as the C
    library's ``sinf`` / ``cosf`` round it, on ``y``'s device."""
    x = y.to(torch.float64)
    n = (torch.trunc(x * _HPI_INV).to(torch.int64) + 0x800000) >> 24   # round(x · 2/π)
    nd = n.to(torch.float64)
    r = (x - nd * _HPI_HEAD) - nd * _HPI_TAIL                         # |r| ≤ π/4
    q = n & 3
    r = torch.where((q == 1) | (q == 2), -r, r)
    r2 = r * r
    odd = r + (r * r2) * _S[0] + ((r * r2) * r2) * (_S[1] + r2 * _S[2])
    r4 = r2 * r2
    even = (_C[0] + r2 * _C[1]) + r4 * _C[2] + (r4 * r2) * (_C[3] + r2 * _C[4])
    even = torch.where((n & 2) != 0, -even, even)
    # sin takes the odd polynomial where n is even, cos where n is odd.
    n_odd = (n & 1) != 0
    return (torch.where(n_odd, even, odd).to(torch.float32),
            torch.where(n_odd, odd, even).to(torch.float32))
