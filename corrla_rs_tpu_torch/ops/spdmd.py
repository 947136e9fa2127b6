"""Sparsity-promoting DMD amplitude selection.

Counterpart of ``corrla_rs_tpu/ops/spdmd.py`` (Jovanovic, Schmid & Nichols
2014): over J(b) = ||X - Phi diag(b) V||_F^2 = b^H P b - q^H b - b^H q + s,
with P = (Phi^H Phi) o conj(V V^H) and q = conj(diag(V X^H Phi)), solve
min_b J(b) + gamma ||b||_1 by ADMM, then polish: the unregularised least
squares on the selected support. Sweeping gamma traces the Pareto front
between model order (nnz) and performance loss.

The only data-sized contractions, Phi^H Phi and X^H Phi, are real products
on the device (the complex modes kept as real and imaginary parts); their
(r, r) and (m, r) results and ||X||^2 are all that go to the host. The
ADMM on the r x r problem is host complex numpy with scipy's
``cho_factor`` of P + rho/2 I, factored once for the sweep, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import _host_f64 as _host
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["spdmd"]


def _complex_grams(phi_re, phi_im, x):
    """(Phi^H Phi, X^H Phi) with the data-sized contractions on the device
    as real products; returns host complex arrays."""
    pp_re = _host(phi_re.mT @ phi_re + phi_im.mT @ phi_im)
    pp_im = _host(phi_re.mT @ phi_im - phi_im.mT @ phi_re)
    xp_re = _host(x.mT @ phi_re)
    xp_im = _host(x.mT @ phi_im)
    return pp_re + 1j * pp_im, xp_re + 1j * xp_im


def _soft(v, k):
    """Complex soft-thresholding (the l1 prox)."""
    mag = np.abs(v)
    scale = np.maximum(1.0 - k / np.maximum(mag, 1e-300), 0.0)
    return scale * v


def spdmd(fit, x_data, gammas, rho: float = 1.0, maxiter: int = 2000,
          eps_abs: float = 1e-7, eps_rel: float = 1e-5):
    """Sparsity-promoting amplitude selection for a fitted DMD model.

    fit: a fitted :class:`~corrla_rs_tpu_torch.models.dmd.DMD` (or any
    object with ``modes_re``/``modes_im`` (n, r) tensors and complex
    ``lambdas`` (r,)); x_data: the (n, m) snapshots the fit should
    reconstruct, taken to the modes' device and dtype; gammas: scalar or
    sequence of l1 weights; rho/maxiter/eps: ADMM knobs.

    Returns a dict of numpy arrays aligned with ``gammas``: ``amplitudes``
    (G, r) complex polished amplitudes, ``nnz`` (G,), ``ploss_pct`` (G,)
    performance loss 100 * ||X - rec|| / ||X||, ``ploss_floor_pct`` (the
    unregularised fit's), plus ``gammas``.
    """
    from scipy.linalg import cho_factor, cho_solve

    lam = np.asarray(fit.lambdas)
    r = lam.shape[0]
    modes_re = fit.modes_re
    x = as_tensor(x_data, device=modes_re.device, dtype=modes_re.dtype)
    if x.ndim != 2 or x.shape[0] != modes_re.shape[0]:
        raise ValueError(
            f"x_data must be ({modes_re.shape[0]}, m), got "
            f"{tuple(x.shape)}"
        )
    m = int(x.shape[1])
    gammas_arr = np.atleast_1d(np.asarray(gammas, np.float64))
    if np.any(gammas_arr < 0):
        raise ValueError("gammas must be >= 0")

    # Vandermonde over the snapshot times
    vand = lam[:, None] ** np.arange(m)[None, :]          # (r, m)
    pp, xp = _complex_grams(modes_re, fit.modes_im, x)
    p_mat = pp * np.conj(vand @ vand.conj().T)            # (r, r)
    q = np.conj(np.diag(vand @ xp))                       # (r,)
    s = float(torch.sum(x * x))
    # P is Hermitian PSD; a tiny ridge for rank-deficient fits
    p_mat = p_mat + 1e-12 * np.trace(p_mat).real / r * np.eye(r)

    def j_of(b):
        return float(np.real(b.conj() @ p_mat @ b
                             - q.conj() @ b - b.conj() @ q + s))

    amps = np.zeros((gammas_arr.size, r), np.complex128)
    nnz = np.zeros(gammas_arr.size, int)
    ploss = np.zeros(gammas_arr.size)
    j0 = max(j_of(np.linalg.solve(p_mat, q)), 0.0)
    denom = max(s, 1e-300)
    # gamma-invariant: factor (P + rho/2 I) once for the whole sweep
    cf = cho_factor(p_mat + 0.5 * rho * np.eye(r))
    for gi, gamma in enumerate(gammas_arr):
        b = np.linalg.solve(p_mat, q)
        z = b.copy()
        u = np.zeros(r, np.complex128)
        for _ in range(int(maxiter)):
            b = cho_solve(cf, q + 0.5 * rho * (z - u))
            z_old = z
            z = _soft(b + u, gamma / rho) if gamma > 0 else b + u
            u = u + b - z
            pri = np.linalg.norm(b - z)
            dua = rho * np.linalg.norm(z - z_old)
            tol_p = (np.sqrt(r) * eps_abs
                     + eps_rel * max(np.linalg.norm(b), np.linalg.norm(z)))
            tol_d = np.sqrt(r) * eps_abs + eps_rel * rho * np.linalg.norm(u)
            if pri < tol_p and dua < tol_d:
                break
        keep = np.abs(z) > 1e-12
        nnz[gi] = int(np.sum(keep))
        b_pol = np.zeros(r, np.complex128)
        if nnz[gi]:
            # polishing: exact LS on the selected support
            pk = p_mat[np.ix_(keep, keep)]
            b_pol[keep] = np.linalg.solve(pk, q[keep])
        amps[gi] = b_pol
        ploss[gi] = 100.0 * np.sqrt(max(j_of(b_pol), 0.0) / denom)
    return {"gammas": gammas_arr, "amplitudes": amps, "nnz": nnz,
            "ploss_pct": ploss, "ploss_floor_pct":
                100.0 * np.sqrt(j0 / denom)}
