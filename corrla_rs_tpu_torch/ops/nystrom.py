"""Randomized Nystrom eigendecomposition of PSD matrices.

Counterpart of ``corrla_rs_tpu/ops/nystrom.py`` (beyond the reference).
Symmetric positive-semidefinite matrices (kernel and covariance Grams) admit
a one-sketch factorization with twice the accuracy per matvec: the Nystrom
approximation

    A_hat = Y (Omega^T Y)^{-1} Y^T,   Y = A Omega

(Tropp, Yurtsever, Udell & Cevher 2017, fixed-rank PSD approximation with
shift stabilization). This module returns its eigendecomposition directly:
top-r eigenpairs of a PSD matrix from ONE pass over A.

Everything is matrix products plus one Cholesky of an (l, l) core, one
tall-skinny CholeskyQR2 and one (l, l) ``eigh``: no general SVD, and nothing
read back from the device. The stabilizing shift nu = eps * ||Y|| makes the
core Cholesky safe in f32 even when A's spectrum underflows the sketch.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["nystrom_eigh", "nystrom_approx"]


def nystrom_eigh(a, rank: int, n_oversamples: int = 8, key=0):
    """Top-``rank`` eigenpairs of a PSD matrix from one sketch pass.

    Returns ``(eigvals (rank,) descending, eigvecs (n, rank))`` of the
    Nystrom approximation ``A_hat = Y (Omega^T Y)^{-1} Y^T``. For spectra
    that decay past ``rank`` the pairs match the true top eigenpairs with
    error O(eigval_{rank+1}); the approximation error ``||A - A_hat||`` is
    within a modest factor of the best rank-``l`` error (Tropp et al. 2017,
    thm 4.1).

    ``a`` must be symmetric PSD (n, n). This is NOT checked (one extra pass
    would double the cost); a symmetric indefinite input produces garbage
    silently. Use ``ops.random_svd`` for general matrices.
    """
    a = as_tensor(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a must be square (n, n), got {tuple(a.shape)}")
    if not 1 <= rank <= a.shape[0]:
        raise ValueError(
            f"rank must be in [1, {a.shape[0]}], got {rank}"
        )
    rank = int(rank)
    n = a.shape[0]
    l = min(rank + int(n_oversamples), n)
    omega = _rsvd._draw_sketch(key, (n, l), a.dtype, a.device)
    y = a @ omega
    # shift: nu ~ eps * ||Y||_F guards the core Cholesky against
    # numerically-indefinite sketches (Tropp et al. 2017, eq. 2.8)
    nu = torch.finfo(a.dtype).eps * torch.linalg.matrix_norm(y)
    y_nu = y + nu * omega
    b = omega.mT @ y_nu
    c = torch.linalg.cholesky(0.5 * (b + b.mT))
    # F = Y_nu C^{-T}: A_hat = F F^T - nu I on the sketch range
    f = torch.linalg.solve_triangular(c, y_nu.mT, upper=False).mT   # (n, l)
    # eigendecomposition of F F^T via thin QR + small eigh (no SVD):
    # F = Q R ; F F^T = Q (R R^T) Q^T ; eigh the (l, l) core
    q = _rsvd._cholesky_qr2(f)
    r = q.mT @ f                                  # (l, l)
    evals, w = torch.linalg.eigh(r @ r.mT)
    evals = (evals - nu).clamp_min(0.0)           # undo the shift
    # eigh returns ascending; take the top `rank` in descending order
    top = slice(l - rank, l)
    return evals[top].flip(0), q @ w[:, top].flip(1)


def nystrom_approx(a, rank: int, n_oversamples: int = 8, key=0):
    """Rank-``rank`` PSD approximation factor: returns ``f (n, rank)``
    with ``A ~= f @ f.T`` (an exact PSD factorization of the truncated
    Nystrom approximant, e.g. a kernel-matrix preconditioner or a feature
    map for downstream least squares)."""
    evals, vecs = nystrom_eigh(a, rank, n_oversamples=n_oversamples,
                               key=key)
    return vecs * torch.sqrt(evals)[None, :]
