"""Robust PCA (principal component pursuit).

Counterpart of ``corrla_rs_tpu/ops/robust_pca.py`` (no reference analogue;
Candes-Li-Ma-Wright 2011, inexact-ALM solver of Lin-Chen-Ma 2010).

NOT the reference's ``rpca`` (that is RANDOMIZED PCA, which this package
mirrors under the same name). Robust PCA decomposes M = L + S with L
low-rank and S sparse by convex relaxation:

    min ||L||_* + lambda ||S||_1   s.t.  L + S = M,

which provably recovers both factors exactly when the corruption is sparse
enough: the standard tool for gross outliers, sensor glitches, and
foreground/background separation, where classical PCA (L2) is destroyed by a
single bad entry.

Every inexact-ALM sweep is one singular-value soft-threshold (an SVD, the
heavy step) plus elementwise shrinkage and residual updates. The sweeps run
in a host loop. The stopping rule is evaluated on the device in every sweep:
once the relative residual is below ``tol`` the iterates freeze under a
mask, and the host reads the flag only every ``_CHECK_EVERY`` sweeps, so the
result is that of stopping at the first sweep below ``tol`` while most
sweeps read nothing back.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["robust_pca"]

# sweeps between two reads of the convergence flag
_CHECK_EVERY = 3


def _ialm_step(m, s, y, mu, lam):
    """One inexact-ALM sweep; returns (l, s, y, residual_fro)."""
    # singular-value soft-threshold of (M - S + Y/mu) at 1/mu
    u, sig, vt = torch.linalg.svd(m - s + y / mu, full_matrices=False)
    sig_t = (sig - 1.0 / mu).clamp_min(0.0)
    l_new = (u * sig_t[None, :]) @ vt
    # elementwise shrinkage of (M - L + Y/mu) at lam/mu
    g = m - l_new + y / mu
    s_new = torch.sign(g) * (g.abs() - lam / mu).clamp_min(0.0)
    resid = m - l_new - s_new
    y_new = y + mu * resid
    return l_new, s_new, y_new, torch.linalg.matrix_norm(resid)


def robust_pca(m_data, lam: float | None = None, mu0: float | None = None,
               rho: float = 1.5, tol: float = 1e-7,
               max_iter: int = 200, mesh=None):
    """Decompose ``m_data`` into low-rank + sparse: M = L + S.

    lam: l1 weight (default the theoretically-universal
    1/sqrt(max(m, n))); mu0: initial penalty (default the standard
    1.25/||M||_2); rho: penalty growth per sweep; tol: relative
    Frobenius feasibility ||M-L-S||/||M||; max_iter: sweep bound.

    mesh: the JAX package's row sharding, not ported (anything but None
    raises).

    Returns (l, s, info) with info = {iterations, rel_residual,
    rank (of L at the numerical-rank tolerance), nnz_frac (of S)}.
    """
    if mesh is not None:
        raise NotImplementedError("robust_pca(mesh=...) is not ported")
    m = as_tensor(m_data)
    if m.ndim != 2:
        raise ValueError(f"m_data must be 2-d, got {m.ndim}-d")
    if max_iter < 1:
        raise ValueError(f"max_iter must be >= 1, got {max_iter}")
    n_r, n_c = int(m.shape[0]), int(m.shape[1])
    if lam is None:
        lam = 1.0 / np.sqrt(max(n_r, n_c))
    if lam <= 0:
        raise ValueError(f"lam must be > 0, got {lam}")
    # one read: the Frobenius norm, the spectral norm (which serves both
    # the penalty and the dual init) and the largest entry
    m_fro, m_2norm, m_max = torch.stack([
        torch.linalg.matrix_norm(m), torch.linalg.matrix_norm(m, 2),
        m.abs().max()]).tolist()
    if m_fro == 0.0:
        z = torch.zeros_like(m)
        return z, z, {"iterations": 0, "rel_residual": 0.0,
                      "rank": 0, "nnz_frac": 0.0}
    if mu0 is None:
        mu0 = 1.25 / m_2norm        # standard IALM init (Lin et al.)
    # dual init Y = M / max(||M||_2, ||M||_inf / lam) (Lin et al.)
    y = m / max(m_2norm, m_max / lam)
    s = torch.zeros_like(m)
    l_mat = s
    mu = float(mu0)
    mu_cap = mu0 * 1e7
    lam = float(lam)
    tol = float(tol)
    done = torch.zeros((), dtype=torch.bool, device=m.device)
    n_done = torch.zeros((), dtype=torch.int64, device=m.device)
    rel = m.new_full((), float("inf"))
    for it in range(1, int(max_iter) + 1):
        l_new, s_new, y_new, r = _ialm_step(m, s, y, mu, lam)
        l_mat = torch.where(done, l_mat, l_new)
        s = torch.where(done, s, s_new)
        y = torch.where(done, y, y_new)
        rel = torch.where(done, rel, r / m_fro)
        n_done = n_done + ~done
        done = done | (rel < tol)
        if (it % _CHECK_EVERY == 0 or it == max_iter) and bool(done):
            break
        mu = min(mu * rho, mu_cap)
    sig = torch.linalg.svdvals(l_mat)
    floor = max(n_r, n_c) * torch.finfo(sig.dtype).eps * 10
    rank_t = torch.sum(sig > sig[0] * floor) * (sig[0] > 0)
    nnz_t = torch.mean((s.abs() > 0).to(rel.dtype))
    its, rel_f, rank, nnz = torch.stack([
        n_done.to(torch.float64), rel.to(torch.float64),
        rank_t.to(torch.float64), nnz_t.to(torch.float64)]).tolist()
    return l_mat, s, {"iterations": int(its), "rel_residual": rel_f,
                      "rank": int(rank), "nnz_frac": nnz}
