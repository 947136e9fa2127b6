"""Correlation / covariance / polynomial-regression layer.

Counterpart of ``corrla_rs_tpu/ops/stats_corr.py`` (reference
stats_corr.rs:14-249). The local polynomial fits take leading batch
dimensions, which is how ``models.active_subspaces`` fits every
neighbourhood at once.

Deviations from the reference, as in the JAX package:

- ``sample_mv_normal`` uses the Cholesky factor by default; the reference
  computes ``cov @ z`` (stats_corr.rs:46-58), ``mode='reference'``;
- ``jac_from_quad`` differentiates the fitted quadratic exactly instead of
  the reference's eps=1e-10 forward difference (stats_corr.rs:230-249). The
  JAX package takes ``vmap(grad)``; here it is the closed-form gradient of
  the Vandermonde, c_lin + x M with M symmetric from the quadratic terms;
- the stray debug ``print!`` in ``rsquared_sens`` is not reproduced.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import random_svd as _random_svd
from corrla_rs_tpu_torch.ops.mat_utils import (
    _fit_pinv,
    center_mat_col,
    pinv,
    zcenter_mat_col,
)
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = [
    "pearson_corr",
    "mat_cov_centered",
    "sample_mv_normal",
    "sandwich_prop",
    "rsquared_sens",
    "mat_col_interactions",
    "linear_fit",
    "jac_from_lin",
    "mat_col_powers",
    "build_vandermonde",
    "build_full_vandermonde",
    "quad_fit",
    "quad_eval",
    "jac_from_quad",
]


def _sharded_cov(x) -> torch.Tensor | None:
    """The covariance of a row-sharded DTensor ``x`` (None for anything
    else): a psum of the column sums, then of the centered (m, m) Gram;
    replicated on every rank."""
    from corrla_rs_tpu_torch.parallel.mesh import _psum, rows_of_dtensor

    rows = rows_of_dtensor(x)
    if rows is None:
        return None
    x_l, (n, *_), mesh, axis = rows
    mean = _psum(x_l.sum(dim=0), mesh, axis) / n
    xc = x_l - mean
    return _psum(xc.mT @ xc, mesh, axis) / (n - 1.0)


def pearson_corr(x: torch.Tensor) -> torch.Tensor:
    """Linear correlation matrix between columns. stats_corr.rs:14-28.
    A row-sharded DTensor gives the same matrix, replicated."""
    cov = _sharded_cov(x)
    if cov is not None:
        sd = torch.sqrt(torch.diagonal(cov))
        return cov / (sd[:, None] * sd[None, :])
    xz = zcenter_mat_col(x)
    return (xz.mT @ xz) / (x.shape[0] - 1.0)


def mat_cov_centered(x: torch.Tensor) -> torch.Tensor:
    """Sample covariance of columns. stats_corr.rs:32-43. A row-sharded
    DTensor gives the same matrix, replicated."""
    cov = _sharded_cov(x)
    if cov is not None:
        return cov
    xc = center_mat_col(x)
    return (xc.mT @ xc) / (x.shape[0] - 1.0)


def sample_mv_normal(cov, n: int, key=0, mode: str = "cholesky",
                     device=None) -> torch.Tensor:
    """Draw n samples from N(0, cov) -> (n, d).

    mode='cholesky' (default): correct MVN sampling via chol(cov) @ z.
    mode='reference': the reference's ``cov @ z`` (covariance cov cov^T),
    kept for parity tests. The standard normals come from the port's one
    normal-draw seam, ``ops.random_svd._draw_sketch``.
    """
    cov = as_tensor(cov, device=device)
    z = _random_svd._draw_sketch(key, (int(n), cov.shape[0]), cov.dtype,
                                 cov.device)
    if mode == "reference":
        return z @ cov.mT
    return z @ torch.linalg.cholesky(cov).mT


def sandwich_prop(cov: torch.Tensor, jac: torch.Tensor) -> torch.Tensor:
    """Sandwich covariance propagation J C J^T. stats_corr.rs:64-68."""
    return (jac @ cov) @ jac.mT


def rsquared_sens(x: torch.Tensor, y: torch.Tensor,
                  cor_dof: bool = False) -> torch.Tensor:
    """R^2 sensitivity R^2 = r_y^T R_xx^+ r_y, optional DoF correction.

    Parity with stats_corr.rs:75-107. Returns a (1, 1) matrix like the
    reference.
    """
    n, k = x.shape
    r_xy = pearson_corr(torch.cat([x, y], dim=1))
    r_xx = r_xy[:-1, :-1]
    r_y = r_xy[:-1, -1:]
    r_sqr = (r_y.mT @ pinv(r_xx)) @ r_y
    if cor_dof:
        r_sqr = 1.0 - (1.0 - r_sqr) * ((n - 1.0) / (n - k - 1.0))
    return r_sqr


def _interaction_indices(k: int, include_self: bool):
    return [(a, b) for a in range(k) for b in range(a, k)
            if include_self or a != b]


def mat_col_interactions(x: torch.Tensor,
                         include_self_interactions: bool) -> torch.Tensor:
    """Columns of pairwise products x_a * x_b in upper-triangle order
    (stats_corr.rs:112-142): x1x1, x1x2, ..., x1xN, x2x2, ..., xNxN.
    Leading dims batch."""
    pairs = _interaction_indices(x.shape[-1], include_self_interactions)
    ia = torch.tensor([p[0] for p in pairs], dtype=torch.long,
                      device=x.device)
    ib = torch.tensor([p[1] for p in pairs], dtype=torch.long,
                      device=x.device)
    return x[..., ia] * x[..., ib]


def _ones_col(x: torch.Tensor) -> torch.Tensor:
    return torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)


def linear_fit(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Least-squares hyperplane fit via Vandermonde pinv. stats_corr.rs:146-160.

    Returns (k+1, y_cols): slopes then intercept. Leading dims batch.
    """
    return _fit_pinv(torch.cat([x, _ones_col(x)], dim=-1)) @ y


def jac_from_lin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Partial derivatives dy/dx_i from a linear fit. stats_corr.rs:164-169.

    Returns (y_cols, k), typically (1, k). Leading dims batch.
    """
    return linear_fit(x, y)[..., :x.shape[-1], :].mT


def mat_col_powers(x: torch.Tensor, max_degree: int) -> torch.Tensor:
    """hstack of x, x^2, ..., x^max_degree. stats_corr.rs:173-180."""
    return torch.cat([x] + [x**d for d in range(2, max_degree + 1)], dim=1)


def build_vandermonde(x: torch.Tensor,
                      include_self_interactions: bool) -> torch.Tensor:
    """[x | interactions(x) | 1]. stats_corr.rs:201-209. Leading dims batch."""
    return torch.cat(
        [x, mat_col_interactions(x, include_self_interactions), _ones_col(x)],
        dim=-1,
    )


def build_full_vandermonde(x: torch.Tensor, degree: int) -> torch.Tensor:
    """Vandermonde used by RBF poly augmentation. stats_corr.rs:183-198.

    degree < 2: [x | 1]; degree >= 2: quadratic with self interactions
    (the reference never goes beyond quadratic).
    """
    if degree < 2:
        return torch.cat([x, _ones_col(x)], dim=-1)
    return build_vandermonde(x, True)


def quad_fit(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Fit a full quadratic in k dims. stats_corr.rs:213-219. Leading dims
    batch."""
    return _fit_pinv(build_vandermonde(x, True)) @ y


def quad_eval(x: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Evaluate the fitted quadratic. stats_corr.rs:222-226."""
    return build_vandermonde(x, True) @ coeffs


def jac_from_quad(x0: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """Gradient of the fitted quadratic (first output column) at each row
    of x0: (n_points, k), exact.

    With coefficients [c_lin (k) | c_ab over pairs a <= b | c_0], the
    gradient is c_lin + x M, where M[a, a] = 2 c_aa and
    M[a, b] = M[b, a] = c_ab. Leading dims of ``coeffs`` (and x0) batch.
    """
    k = x0.shape[-1]
    c = coeffs[..., 0]
    pairs = _interaction_indices(k, True)
    ia = torch.tensor([p[0] for p in pairs], dtype=torch.long,
                      device=c.device)
    ib = torch.tensor([p[1] for p in pairs], dtype=torch.long,
                      device=c.device)
    c_quad = c[..., k:k + len(pairs)]
    m = torch.zeros(c.shape[:-1] + (k, k), dtype=c.dtype, device=c.device)
    m[..., ia, ib] += c_quad
    m[..., ib, ia] += c_quad
    return c[..., None, :k] + x0 @ m
