"""Canonical correlation analysis (extension; no reference analogue).

Counterpart of ``corrla_rs_tpu/ops/cca.py``: the pairs of directions
(a_i, b_i) maximizing corr(X a_i, Y b_i), mutually uncorrelated across
pairs. The Gram products, the Cholesky whitening of Sxx/Syy
(ridge-regularized) and one SVD of the (p, q) whitened cross-covariance all
run on the data's device; the SVD gives every pair at once:

a_i = Lx^{-T} u_i, b_i = Ly^{-T} v_i where Lx = chol(Sxx + reg I) and
M = Lx^{-1} Sxy Ly^{-T} = U diag(rho) V^T.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import _host_f64, as_tensor

__all__ = ["Cca", "cca"]


def _cca_kernel(x, y, n_components: int, reg: float):
    n = x.shape[0]
    xm, ym = x.mean(dim=0), y.mean(dim=0)
    xc, yc = x - xm[None, :], y - ym[None, :]
    sxx = xc.mT @ xc / (n - 1)
    syy = yc.mT @ yc / (n - 1)
    sxy = xc.mT @ yc / (n - 1)
    jit_x = (reg + 1e-12) * torch.trace(sxx) / sxx.shape[0]
    jit_y = (reg + 1e-12) * torch.trace(syy) / syy.shape[0]
    lx = torch.linalg.cholesky(
        sxx + jit_x * torch.eye(sxx.shape[0], dtype=x.dtype, device=x.device))
    ly = torch.linalg.cholesky(
        syy + jit_y * torch.eye(syy.shape[0], dtype=x.dtype, device=x.device))
    # M = Lx^{-1} Sxy Ly^{-T}
    m = torch.linalg.solve_triangular(lx, sxy, upper=False)
    m = torch.linalg.solve_triangular(ly, m.mT, upper=False).mT
    u, rho, vt = torch.linalg.svd(m, full_matrices=False)
    wx = torch.linalg.solve_triangular(lx.mT, u[:, :n_components],
                                       upper=True)
    wy = torch.linalg.solve_triangular(ly.mT, vt.mT[:, :n_components],
                                       upper=True)
    return rho[:n_components], wx, wy, xm, ym


@register_model_class
class Cca:
    """Fitted CCA model (see :func:`cca`). Attributes:

    ``corrs`` (k,) canonical correlations (descending, in [0, 1]; a host
    numpy array, as in the JAX package); ``x_weights`` (p, k) /
    ``y_weights`` (q, k) canonical directions, scaled so the training
    variates have unit variance; ``transform(x, y) -> (u, v)`` canonical
    variates of new data. Checkpointable through utils/checkpoint.
    """

    def transform(self, x=None, y=None):
        """Canonical variates of new rows: returns (u, v); the member
        for a block passed as None is None. Numpy rows go to the fit's
        device."""
        u = v = None
        if x is not None:
            xt = as_tensor(x, device=self.x_weights.device,
                           dtype=self.x_weights.dtype)
            u = (xt - self.x_mean[None, :]) @ self.x_weights
        if y is not None:
            yt = as_tensor(y, device=self.y_weights.device,
                           dtype=self.y_weights.dtype)
            v = (yt - self.y_mean[None, :]) @ self.y_weights
        return u, v

    def score(self, x, y) -> np.ndarray:
        """Per-component Pearson correlation of the canonical variates
        on held-out data (the out-of-sample canonical correlations), as a
        host numpy array."""
        u, v = (_host_f64(t) for t in self.transform(x, y))
        u = u - u.mean(axis=0)
        v = v - v.mean(axis=0)
        num = np.sum(u * v, axis=0)
        den = np.linalg.norm(u, axis=0) * np.linalg.norm(v, axis=0)
        return num / np.where(den > 0, den, 1.0)


def cca(x_data, y_data, n_components: int | None = None,
        reg: float = 0.0, device=None) -> Cca:
    """Canonical correlation analysis of two blocks of columns.

    x_data: (n, p), y_data: (n, q), same rows (observations).
    n_components: number of canonical pairs (default min(p, q)).
    reg: ridge on both block covariances, as a fraction of their mean
    eigenvalue (the regularized CCA of Vinod 1976). Numpy input goes to
    ``device`` (default ``utils.device.default_device()``); y follows x.
    """
    x = as_tensor(x_data, device=device)
    y = as_tensor(y_data, device=x.device)
    if x.ndim != 2 or y.ndim != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"x, y must be 2-d with equal rows, got {np.shape(x_data)} "
            f"and {np.shape(y_data)}"
        )
    if x.shape[0] < 3:
        raise ValueError(f"need >= 3 rows, got {x.shape[0]}")
    k_max = int(min(x.shape[1], y.shape[1]))
    k = k_max if n_components is None else int(n_components)
    if not 1 <= k <= k_max:
        raise ValueError(
            f"n_components must be in [1, {k_max}], got {n_components}"
        )
    if reg < 0:
        raise ValueError(f"reg must be >= 0, got {reg}")
    dt = torch.promote_types(x.dtype, y.dtype)
    rho, wx, wy, mx, my = _cca_kernel(x.to(dt), y.to(dt), k, float(reg))
    out = Cca.__new__(Cca)
    out.n_components = k
    out.corrs = rho.cpu().numpy()
    out.x_weights = wx
    out.y_weights = wy
    out.x_mean = mx
    out.y_mean = my
    return out
