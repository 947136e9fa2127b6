"""Partial least squares regression (SIMPLS), an extension.

Counterpart of ``corrla_rs_tpu/ops/pls.py``. PLS regresses through k latent
directions chosen to maximize covariance with the response: the standard
tool for p >~ n with correlated columns. SIMPLS (de Jong 1993): each
component is the dominant left singular vector of the deflated (p, q)
cross-covariance S, so the O(n p) work is two Gram products and the
components are a host loop of small device steps (the JAX package's
``fori_loop``), which reads nothing back. For univariate y SIMPLS coincides
with NIPALS-PLS1.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import _host_f64, as_tensor

__all__ = ["PlsRegressor", "pls_fit"]


def _simpls_kernel(x, y, k: int):
    """SIMPLS on centered data. Returns (coef, x_mean, y_mean,
    x_weights R)."""
    p, q = x.shape[1], y.shape[1]
    xm, ym = x.mean(dim=0), y.mean(dim=0)
    xc, yc = x - xm[None, :], y - ym[None, :]
    gram = xc.mT @ xc                           # (p, p)
    s = xc.mT @ yc                              # (p, q)
    rs = x.new_zeros((p, k))
    ps = x.new_zeros((p, k))
    qs = x.new_zeros((q, k))
    vs = x.new_zeros((p, k))
    for i in range(k):
        # dominant left singular vector of s via the (q, q) eigh
        c = torch.linalg.eigh(s.mT @ s).eigenvectors[:, -1]
        r = s @ c
        r = r / torch.linalg.vector_norm(r).clamp_min(1e-300)
        gr = gram @ r                           # X^T X r
        tt = (r @ gr).clamp_min(1e-300)         # ||t||^2 = r^T X^T X r
        p_load = gr / tt
        q_load = (s.mT @ r) / tt
        # orthonormal basis of the loading span; deflate S against it
        v = p_load - vs @ (vs.mT @ p_load)
        v = v / torch.linalg.vector_norm(v).clamp_min(1e-300)
        s = s - v[:, None] @ (v[None, :] @ s)
        rs[:, i] = r
        ps[:, i] = p_load
        qs[:, i] = q_load
        vs[:, i] = v
    return rs @ qs.mT, xm, ym, rs


@register_model_class
class PlsRegressor:
    """Fitted SIMPLS model (see :func:`pls_fit`). ``coef`` (p, q) maps
    centered predictors to centered responses; ``x_weights`` (p, k) are
    the latent directions (X scores = Xc @ x_weights)."""

    def _rows(self, x_new) -> torch.Tensor:
        return as_tensor(x_new, device=self.coef.device,
                         dtype=self.coef.dtype)

    def predict(self, x_new) -> torch.Tensor:
        """(m, q) predicted responses for (m, p) new rows."""
        return ((self._rows(x_new) - self.x_mean[None, :]) @ self.coef
                + self.y_mean[None, :])

    def transform(self, x_new) -> torch.Tensor:
        """(m, k) latent scores of new rows."""
        return (self._rows(x_new) - self.x_mean[None, :]) @ self.x_weights

    def score(self, x_new, y_new) -> float:
        """R^2 of ``predict`` on held-out data (uniform average over
        response columns, sklearn convention)."""
        y = _host_f64(y_new)
        if y.ndim == 1:
            y = y[:, None]
        pred = _host_f64(self.predict(x_new))
        ss_res = np.sum((y - pred) ** 2, axis=0)
        ss_tot = np.sum((y - y.mean(axis=0)) ** 2, axis=0)
        return float(np.mean(1.0 - ss_res / np.where(ss_tot > 0, ss_tot,
                                                     1.0)))


def pls_fit(x_data, y_data, n_components: int, device=None) -> PlsRegressor:
    """Fit a SIMPLS partial-least-squares regression.

    x_data: (n, p) predictors, y_data: (n,) or (n, q) responses.
    n_components: number of latent components (1 <= k <= min(n-1, p)).
    Numpy input goes to ``device`` (default
    ``utils.device.default_device()``); y follows x.
    """
    x = as_tensor(x_data, device=device)
    y = as_tensor(y_data, device=x.device)
    if y.ndim == 1:
        y = y[:, None]
    if x.ndim != 2 or y.ndim != 2 or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"x, y must be 2-d with equal rows, got {np.shape(x_data)} "
            f"and {np.shape(y_data)}"
        )
    k_max = int(min(x.shape[0] - 1, x.shape[1]))
    k = int(n_components)
    if not 1 <= k <= k_max:
        raise ValueError(
            f"n_components must be in [1, {k_max}], got {n_components}"
        )
    dt = torch.promote_types(x.dtype, y.dtype)
    coef, xm, ym, rs = _simpls_kernel(x.to(dt), y.to(dt), k)
    out = PlsRegressor.__new__(PlsRegressor)
    out.n_components = k
    out.coef = coef
    out.x_mean = xm
    out.y_mean = ym
    out.x_weights = rs
    return out
