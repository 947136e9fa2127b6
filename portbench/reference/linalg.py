"""Plain dense linear algebra for the references, in a stated precision.

``Arith`` names the precision a reference computes in: float64, float32 with
TF32 off, or float32 with every matrix product in TF32 (the control). The
products go through ``Arith.mm``, so the precision reaches every place where
a GEMM would take it: the trailing updates of the blocked LU, the kernel
matrix times the coefficients, the Gram matrices. On a CUDA device TF32 is
cuBLAS's own (``torch.backends.cuda.matmul.allow_tf32`` for the product); on
the CPU, which has no TF32, the operands are rounded to TF32's 10-bit
mantissa and multiplied in float32, which is what the tensor core does.

Nothing here imports the program under test.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

__all__ = ["Arith", "F64", "F32", "TF32", "tf32_round", "pairwise_dists",
           "lu_solve", "support_gap"]


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to the nearest TF32 value (10 mantissa bits,
    ties away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def _cuda_tf32(on: bool):
    flag = torch.backends.cuda.matmul
    old = flag.allow_tf32
    flag.allow_tf32 = on
    try:
        yield
    finally:
        flag.allow_tf32 = old


@dataclass(frozen=True)
class Arith:
    """The precision of a reference: its dtype, and whether its products run
    in TF32 (float32 only)."""
    dtype: torch.dtype
    tf32: bool = False

    @property
    def name(self) -> str:
        if self.tf32:
            return "tf32"
        return "float64" if self.dtype == torch.float64 else "float32"

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b in this precision."""
        if not self.tf32:
            if a.is_cuda:
                with _cuda_tf32(False):
                    return a @ b
            return a @ b
        if a.is_cuda:
            with _cuda_tf32(True):
                return a @ b
        return tf32_round(a) @ tf32_round(b)


F64 = Arith(torch.float64)
F32 = Arith(torch.float32)
TF32 = Arith(torch.float32, tf32=True)


def pairwise_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j|| (n_a, n_b) from direct differences, one coordinate at a
    time: exact to rounding, zero on coincident points."""
    d2 = torch.zeros((a.shape[0], b.shape[0]), dtype=a.dtype,
                     device=a.device)
    for k in range(a.shape[1]):
        diff = a[:, k, None] - b[None, :, k]
        d2.addcmul_(diff, diff)
    return d2.sqrt_()


def support_gap(got: torch.Tensor, given: torch.Tensor) -> float:
    """max |got - given| of a fitted model's support points against the
    input's, inf where the shapes differ: 0 where the model is the model of
    this input."""
    if tuple(got.shape) != tuple(given.shape):
        return float("inf")
    return (got.to(torch.float64) - given.to(torch.float64)).abs().max().item()


def _swaps_to_perm(piv: torch.Tensor, rows: int) -> torch.Tensor:
    """LAPACK row interchanges (1-based, applied in order) as a permutation
    of ``rows`` rows."""
    perm = list(range(rows))
    for i, p in enumerate(piv.tolist()):
        p -= 1
        perm[i], perm[p] = perm[p], perm[i]
    return torch.tensor(perm, device=piv.device)


@contextlib.contextmanager
def _cusolver():
    """cuSOLVER for the panels: MAGMA's routines print a warning a call on
    tall panels."""
    pick = torch.backends.cuda.preferred_linalg_library
    old = pick()
    pick("cusolver")
    try:
        yield
    finally:
        pick(old)


def lu_solve(a: torch.Tensor, b: torch.Tensor, arith: Arith,
             block: int = 256) -> torch.Tensor:
    """Solve a x = b by a right-looking blocked LU with partial pivoting.

    Each panel is factored by ``torch.linalg.lu_factor``, and the trailing
    matrix is updated by ``arith.mm``, where nearly all of the operations
    lie; ``a`` and ``b`` are cast to ``arith.dtype`` and not modified."""
    with _cusolver() if a.is_cuda else contextlib.nullcontext():
        return _lu_solve(a, b, arith, block)


def _lu_solve(a, b, arith, block):
    a = a.to(arith.dtype, copy=True)
    b = b.to(arith.dtype, copy=True)
    n = a.shape[0]
    for k in range(0, n, block):
        e = min(k + block, n)
        lu, piv = torch.linalg.lu_factor(a[k:, k:e])
        perm = _swaps_to_perm(piv, n - k)
        a[k:] = a[k:][perm]
        b[k:] = b[k:][perm]
        a[k:, k:e] = lu
        if e < n:
            a[k:e, e:] = torch.linalg.solve_triangular(
                lu[:e - k], a[k:e, e:], upper=False, unitriangular=True)
            a[e:, e:] -= arith.mm(lu[e - k:], a[k:e, e:])
    y = torch.linalg.solve_triangular(a, b, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(a, y, upper=True)
