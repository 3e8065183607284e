"""Exhaustive check: ``log_f32``'s multiply-adds need no round-to-odd.

``accel/numerics.py::log_f32`` fuses its nine multiply-adds with
``_fma_log`` (the float64 sum rounded once to float32), where ``_fma``
also rounds the float64 sum to odd first. The two differ only where an
inexact float64 sum lies halfway between two float32s. The first eight
multiply-adds depend only on the mantissa, the ninth also on the exponent
term e in [-126, 128]; this script feeds every mantissa (both branches of
the sqrt(1/2) split) and, for the ninth, every e through both, each step
on the same inputs, and prints how many results differ (0 expected).

Run: ``PYTHONPATH=src python tests/exhaustive_log_fma.py`` (about 150 s
on one CPU core). ``tests/test_torch_log_fma.py`` runs it at a few
exponents.
"""
from __future__ import annotations

import torch

from repro_torch.accel import numerics as tn

#: log_f32's exponent term: floor(log2) + 1, less 1 below sqrt(1/2)
EXPONENTS = range(-126, 129)


def mantissa_steps():
    """Every mantissa's z, z^3 and the eighth multiply-add's result, and how
    many of the first eight results differ between ``_fma_log`` and
    ``_fma`` (each step on the ``_fma_log`` chain's inputs)."""
    m = (torch.arange(0, 1 << 23, dtype=torch.int32) | 0x3f000000).view(torch.float32)
    low = m < tn._SQRTHF
    z = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    z3 = z * z * z
    P = tn._LOG_P
    differ = 0

    def step(a, b, c):
        nonlocal differ
        r = tn._fma_log(a, b, c)
        differ += int((r != tn._fma(a, b, c)).sum())
        return r

    y, y1, y2 = step(z, P[0], P[1]), step(z, P[3], P[4]), step(z, P[6], P[7])
    y, y1, y2 = step(y, z, P[2]), step(y1, z, P[5]), step(y2, z, P[8])
    y = step(step(y, z3, y1), z3, y2)
    return z3, y, differ


def last_step_differ(y: torch.Tensor, z3: torch.Tensor, e: int) -> int:
    """The ninth multiply-add, y z^3 + e Q1, at every mantissa."""
    c = torch.full_like(y, float(e)) * tn._LN2_LO
    return int((tn._fma_log(y, z3, c) != tn._fma(y, z3, c)).sum())


def main() -> None:
    z3, y, differ = mantissa_steps()
    print(f"first eight multiply-adds, {8 * z3.numel()} results: {differ} differ")
    last = sum(last_step_differ(y, z3, e) for e in EXPONENTS)
    print(f"ninth, {len(EXPONENTS) * z3.numel()} results: {last} differ")


if __name__ == "__main__":
    main()
