"""Preconditioned conjugate gradient: batched, matrix-free.

Counterpart of ``corrla_rs_tpu/ops/cg.py`` (beyond the reference). The
library's direct solvers (Cholesky/LU/QR) need the operator densely; its
randomized ones (sketched_lstsq) target least squares. This is the canonical
ITERATIVE SPD solver, so kernel systems, covariance solves and
Laplacian-like operators can be solved matrix-free at scales where
O(n^3)/O(n^2) storage is off the table. It pairs with ops/slq.py (solves +
logdet = full GP inference via matvecs only).

Every RHS column advances in lockstep: one batched (n, k) operator
application per iteration, scalars per column via reductions. A column that
has converged freezes under a mask, so further iterations leave it as it is.
The loop runs on the host and asks the device every ``_CHECK_EVERY``
iterations whether every column has frozen; if so it stops, and the rest of
the residual history holds the frozen norms, which is what the remaining
iterations would have written. Per-column residual histories come back for
diagnosis.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from corrla_rs_tpu_torch.ops.mat_utils import apply_operator as _apply
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["CgResult", "cg_solve", "jacobi_preconditioner",
           "nystrom_preconditioner"]

# iterations between two reads of "has every column converged"
_CHECK_EVERY = 8


class CgResult(NamedTuple):
    x: torch.Tensor            # (n,) or (n, k) solution(s)
    residual_norms: torch.Tensor  # (n_iters + 1, k) per-iteration ||r||_2
    converged: torch.Tensor    # (k,) bool, ||r|| <= tol * ||b||
    n_iters: int


def jacobi_preconditioner(a) -> Callable:
    """Diagonal (Jacobi) preconditioner M^-1 v = v / diag(A) for an
    explicit matrix: the zero-thought default for diagonally dominant
    kernels."""
    d = torch.diagonal(as_tensor(a))
    inv = torch.where(d != 0, 1.0 / d, torch.ones_like(d))

    def apply(v):
        return v * inv[:, None]

    return apply


def nystrom_preconditioner(a, rank: int, mu: float,
                           n_oversamples: int = 8, key=0) -> Callable:
    """Randomized Nystrom preconditioner for (A + mu I) x = b, A PSD
    (Frangella, Tropp & Udell 2023): one sketch of A gives a rank-r
    eigenapproximation U diag(lam) U^T, and

        P^-1 = U diag((lam_r + mu) / (lam + mu)) U^T + (I - U U^T)

    clusters the preconditioned spectrum near 1 wherever A's spectrum
    decays past ``rank``: regularized kernel/covariance solves converge
    in O(1) CG iterations instead of O(sqrt(cond)). Pass the result as
    ``cg_solve(a_plus_mu, b, preconditioner=...)``; building it costs
    one (n, r) sketch product + one small eigh.
    """
    from corrla_rs_tpu_torch.ops.nystrom import nystrom_eigh

    lam, u = nystrom_eigh(a, int(rank), n_oversamples=n_oversamples,
                          key=key)
    lam = lam.clamp_min(0.0)
    scale = (lam[-1] + mu) / (lam + mu)          # (r,)

    def apply(v):
        utv = u.mT @ v                            # (r, k)
        return v + u @ ((scale - 1.0)[:, None] * utv)

    return apply


def cg_solve(a, b, x0=None, n_iters: int = 100, tol: float = 1e-8,
             preconditioner: Callable | None = None) -> CgResult:
    """Solve A x = b for SPD A, batched over RHS columns.

    a : (n, n) SPD matrix or batched matvec callable (n, k) -> (n, k).
    b : (n,) or (n, k).
    preconditioner : optional callable v (n, k) -> M^-1 v (n, k)
        (see :func:`jacobi_preconditioner`).
    tol : relative residual target; converged columns freeze (mask). At
        most ``n_iters`` iterations run, fewer once every column has
        frozen; ``residual_norms`` has ``n_iters + 1`` rows either way.
    """
    b = as_tensor(b)
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    n, k = bb.shape
    finfo = torch.finfo(bb.dtype)
    n_iters = int(n_iters)
    if n_iters < 1:
        raise ValueError(f"n_iters must be >= 1, got {n_iters}")
    if x0 is None:
        x = torch.zeros_like(bb)
    else:
        x = as_tensor(x0, device=bb.device)
        x = x[:, None] if vec else x
    if x.shape != bb.shape:
        raise ValueError(f"x0 shape {tuple(x.shape)} != b shape "
                         f"{tuple(bb.shape)}")
    if not callable(a):
        a = as_tensor(a, device=bb.device)
    precond = preconditioner if preconditioner is not None else (
        lambda v: v)

    def safe(v):
        return torch.where(v.abs() > finfo.tiny, v, torch.ones_like(v))

    r = bb - _apply(a, x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z, dim=0)                      # (k,)
    b_norm = torch.linalg.vector_norm(bb, dim=0).clamp_min(finfo.tiny)
    hist = bb.new_zeros((n_iters + 1, k))
    done = n_iters
    for i in range(n_iters):
        r_norm = torch.linalg.vector_norm(r, dim=0)
        hist[i] = r_norm
        active = (r_norm / b_norm) > tol              # (k,)
        if i % _CHECK_EVERY == 0 and i and not bool(active.any()):
            done = i
            break
        ap = _apply(a, p)
        denom = torch.sum(p * ap, dim=0)
        alpha = torch.where(active, rz / safe(denom), torch.zeros_like(rz))
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = precond(r)
        rz_new = torch.sum(r * z, dim=0)
        beta = torch.where(active, rz_new / safe(rz), torch.zeros_like(rz))
        p = z + beta[None, :] * p
        rz = rz_new
    final_norm = torch.linalg.vector_norm(r, dim=0)
    hist[done:] = final_norm
    converged = (final_norm / b_norm) <= tol
    return CgResult(
        x=x[:, 0] if vec else x,
        residual_norms=hist,
        converged=converged[0] if vec else converged,
        n_iters=n_iters,
    )
