"""Peaks of the card, the least time of a piece of work, and the card line.

Copied from ``chip_smoke.py`` (``PEAK_BYTES_S``, ``PEAK_F32_FLOPS``,
``PEAK_F64_FLOPS``, ``bound``, and the operation count of the RBF matvec of
its kernel table: 3d + 1 operations a (query, support point) pair and 2 a
column) and its ``nvidia_smi``, so that the yardstick stays as it is when
the program changes.
"""
from __future__ import annotations

import subprocess

__all__ = ["PEAK_BYTES_S", "PEAK_F32_FLOPS", "PEAK_F64_FLOPS", "bound_s",
           "rbf_matvec_bound_s", "card_line"]

# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, f32 and f64
# FLOP/s outside the tensor cores
PEAK_BYTES_S, PEAK_F32_FLOPS, PEAK_F64_FLOPS = 3.35e12, 67e12, 34e12


def bound_s(n_bytes: float, n_ops: float, itemsize: int = 4) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak of their type outside the
    tensor cores."""
    peak = PEAK_F32_FLOPS if itemsize == 4 else PEAK_F64_FLOPS
    return max(n_bytes / PEAK_BYTES_S, n_ops / peak)


def rbf_matvec_bound_s(m: int, n: int, d: int, c: int,
                       itemsize: int = 4) -> float:
    """Least time of y = phi(||q_i - x_j||) C for m queries, n support
    points of d dimensions and c columns: the inputs read and the output
    written once, (3d + 1) operations a pair and 2 a column."""
    n_bytes = itemsize * (m * d + n * d + n * c + m * c)
    return bound_s(n_bytes, m * n * (3 * d + 1 + 2 * c), itemsize)


def card_line() -> str:
    """``name, power limit`` of the first card, from ``nvidia-smi``."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]
