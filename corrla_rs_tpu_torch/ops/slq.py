"""Stochastic Lanczos quadrature: log-determinants and spectral sums.

Counterpart of ``corrla_rs_tpu/ops/slq.py`` (no reference analogue).
Completes the randomized trace toolbox (ops/trace_est.py estimates tr(A);
this module estimates tr(f(A)) for any scalar ``f``): log-determinants
(f = log: Gaussian-process evidence, Gaussian entropies), traces of inverses
(f = 1/x: uncertainty calibration), Schatten norms, spectral counts. Ubaru,
Chen & Saad 2017: for each Rademacher probe v, m Lanczos steps build a
tridiagonal T_m whose Gauss-quadrature rule integrates f against v's
spectral measure:

    v^T f(A) v  ~=  ||v||^2 * sum_k tau_k^2 f(theta_k),

with (theta, tau) the eigenvalues and first-row eigenvector components of
T_m; averaging over probes estimates tr f(A). Error decays EXPONENTIALLY in m
for smooth f (quadrature) and as 1/sqrt(n_probes) (Monte Carlo), so m ~ 40,
p ~ 24 gives 3-digit log-dets of well-conditioned operators at O(p * m)
matvecs total.

All probes advance in LOCKSTEP as one (n, p) block: one batched matvec per
Lanczos step, full reorthogonalization as two products against the stored
basis, then one batched (p, m, m) ``eigh``. The loop over the m steps runs on
the host and reads nothing back. Matrix-free operators use the same
batched-callable protocol as ops/trace_est (``a``: (n, k) -> (n, k) with
``n_dim=``).
"""
from __future__ import annotations

from typing import Callable

import torch

from corrla_rs_tpu_torch.ops import trace_est as _trace
from corrla_rs_tpu_torch.ops.mat_utils import apply_operator as _apply
from corrla_rs_tpu_torch.utils.device import as_tensor, default_device

__all__ = ["slq_spectral_sum", "slq_logdet", "lanczos_tridiag",
           "lanczos_fn_apply"]


def _lanczos(v0, a, m):
    """Batched Lanczos with full reorthogonalization.

    v0 (n, p): unit-norm starting vectors (columns). Returns
    (alphas (m, p), betas (m-1, p), basis (m, n, p)): the tridiagonal
    coefficients per probe and the Lanczos vectors. Full reorth costs two
    products per step against the stored basis; at the m ~ 40-60 this
    module targets it is cheap and removes the ghost-eigenvalue failure
    mode of plain Lanczos.
    """
    n, p = v0.shape
    tiny = torch.finfo(v0.dtype).tiny
    # slot j holds v_j; slot m takes the last, unused v_m
    basis = v0.new_zeros((m + 1, n, p))
    basis[0] = v0
    alphas = v0.new_zeros((m, p))
    betas = v0.new_zeros((m, p))
    v_prev, v_cur = torch.zeros_like(v0), v0
    beta = v0.new_zeros((p,))
    for j in range(m):
        w = _apply(a, v_cur) - beta[None, :] * v_prev
        alpha = torch.sum(v_cur * w, dim=0)
        w = w - alpha[None, :] * v_cur
        # full reorthogonalization against the slots filled so far
        filled = basis[:j + 1]
        coefs = torch.einsum("knp,np->kp", filled, w)
        w = w - torch.einsum("knp,kp->np", filled, coefs)
        beta = torch.linalg.vector_norm(w, dim=0)
        v_prev, v_cur = v_cur, w / beta.clamp_min(tiny)[None, :]
        alphas[j] = alpha
        betas[j] = beta
        basis[j + 1] = v_cur
    return alphas, betas[: m - 1], basis[:m]


def lanczos_tridiag(a, v0, m: int):
    """Public batched Lanczos: (alphas (m, p), betas (m-1, p)) for
    unit-norm starting block v0 (n, p). ``a``: (n, n) matrix or batched
    matvec callable."""
    v0 = as_tensor(v0)
    if not callable(a):
        a = as_tensor(a, device=v0.device)
    return _lanczos(v0, a, int(m))[:2]


def _tridiag_eigh(alphas, betas):
    """eigh of the (p, m, m) tridiagonals of batched coefficients."""
    t = (torch.diag_embed(alphas.mT) + torch.diag_embed(betas.mT, offset=1)
         + torch.diag_embed(betas.mT, offset=-1))
    return torch.linalg.eigh(t)


def _quadrature(alphas, betas, f):
    """Gauss-quadrature spectral sums from batched tridiagonal coeffs:
    per probe, sum_k tau_k^2 f(theta_k)."""
    theta, vecs = _tridiag_eigh(alphas, betas)
    tau2 = vecs[:, 0, :] ** 2                            # (p, m)
    return torch.sum(tau2 * f(theta), dim=1)             # (p,)


def slq_spectral_sum(a, f: Callable, n_probes: int = 24,
                     n_lanczos: int = 40, key=0, n_dim: int | None = None,
                     dtype=None) -> float:
    """Estimate tr(f(A)) for symmetric (PSD for f=log) A.

    ``a``: (n, n) matrix or batched matvec callable (n, k) -> (n, k)
    (callables must pass ``n_dim``; their probes are ``dtype``, default
    ``torch.get_default_dtype()``, on the default device: the same contract
    as ops/trace_est.hutchpp_trace).
    """
    if n_probes < 1:
        raise ValueError(f"n_probes must be >= 1, got {n_probes}")
    if n_lanczos < 2:
        raise ValueError(f"n_lanczos must be >= 2, got {n_lanczos}")
    if callable(a):
        if n_dim is None:
            raise ValueError("callable operators need n_dim=")
        n = int(n_dim)
        probe_dtype = dtype or torch.get_default_dtype()
        dev = default_device()
    else:
        a = as_tensor(a)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"a must be square, got {tuple(a.shape)}")
        n = int(a.shape[0])
        probe_dtype = dtype or a.dtype
        dev = a.device
    m = min(int(n_lanczos), n)
    v = _trace._rademacher(key, (n, int(n_probes)), probe_dtype, dev)
    v = v / n ** 0.5   # unit columns, exactly
    alphas, betas, _basis = _lanczos(v, a, m)
    per_probe = _quadrature(alphas, betas, f)        # v^T f(A) v / ||v||^2
    return float(n * torch.mean(per_probe))


def slq_logdet(a, n_probes: int = 24, n_lanczos: int = 40, key=0,
               n_dim: int | None = None, dtype=None) -> float:
    """log det(A) for symmetric positive-definite A via SLQ.

    Eigenvalue estimates are clamped to the dtype's tiny before the log:
    a Ritz value can round to <= 0 only when A is numerically singular,
    where logdet is -inf-adjacent anyway."""
    def f(x):
        return torch.log(x.clamp_min(torch.finfo(x.dtype).tiny))

    return slq_spectral_sum(a, f, n_probes=n_probes, n_lanczos=n_lanczos,
                            key=key, n_dim=n_dim, dtype=dtype)


def lanczos_fn_apply(a, b, f: Callable, n_lanczos: int = 40):
    """f(A) @ b for symmetric A via the Lanczos approximation
    f(A) b ~= ||b|| V_m f(T_m) e1 (Saad 1992): matrix exponentials
    (exponential integrators), inverse square roots (sampling
    N(0, A^-1) / whitening), fractional powers, all WITHOUT forming
    f(A): m matvecs per column, exact when A's action on the Krylov
    space is degree-< m polynomial. Columns of b (n, k) run in
    lockstep (batched Lanczos, one batched eigh of the k tridiagonals).
    """
    b = as_tensor(b)
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    norms = torch.linalg.vector_norm(bb, dim=0)
    v0 = bb / norms.clamp_min(torch.finfo(bb.dtype).tiny)[None, :]
    m = min(int(n_lanczos), bb.shape[0])
    if not callable(a):
        a = as_tensor(a, device=bb.device)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"a must be square, got {tuple(a.shape)}")
    alphas, betas, basis = _lanczos(v0, a, m)
    theta, vecs = _tridiag_eigh(alphas, betas)           # (k, m), (k, m, m)
    # f(T) e1 = S f(theta) S^T e1
    coef = torch.einsum("kmj,kj->km", vecs, f(theta) * vecs[:, 0, :])
    y = torch.einsum("mnk,km->nk", basis, coef) * norms[None, :]
    return y[:, 0] if vec else y
