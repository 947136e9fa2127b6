"""Gaussian-process regression.

Counterpart of ``corrla_rs_tpu/ops/gp.py``: exact GP with RBF / Matern-5/2 /
Matern-3/2 kernels, Cholesky solves, and marginal-likelihood hyperparameter
optimisation with exact gradients (BFGS in log-parameter space), plus the
Titsias (2009) sparse variational GP for large training sets.

Every distance matrix comes from ``interp.pairwise_dists``, which launches
the kernel-matrix kernel (phi = linear) on CUDA tensors: K (n, n) and K_q
(n_q, n) of the exact GP, K_mm and K_mn (m, n) of the sparse one. A fit
computes its distances once: the hyperparameter MLE differentiates only the
log-parameters, on the port's ``optimize._bfgs``, so the distances are
constants of the objective (the JAX ``_nlml`` recomputes them inside
``jit``). Predictions keep the graph through the query points, which
``bayes_opt`` differentiates through the distance Function's backward.

``torch.linalg.cholesky`` raises on a matrix that is not positive definite,
where JAX returns NaN; the objectives factor with ``cholesky_ex`` and return
NaN there, which the BFGS line search rejects as JAX's does. The sparse
GP's chol(I + A A^T) is the R factor of QR([A^T; I]) as in the JAX package;
its gradient needs the reduced QR (torch has no derivative of mode "r").
"""
from __future__ import annotations

import math

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.ops.interp import pairwise_dists
from corrla_rs_tpu_torch.ops.optimize import _bfgs
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["GpRegressor", "SparseGpRegressor", "gp_kernel_eval"]

_LOG_2PI = math.log(2.0 * math.pi)
# entries of one block of the exact GP's (n_q, n) cross covariance: 2 GB in
# f64
_QUERY_BLOCK_ELEMS = 1 << 28


def gp_kernel_eval(r: torch.Tensor, kernel: str, length_scale, signal_var):
    """Stationary covariance k(r) for distance matrix r."""
    s = r / length_scale
    if kernel == "rbf":
        return signal_var * torch.exp(-0.5 * s * s)
    if kernel == "matern52":
        c = math.sqrt(5.0) * s
        return signal_var * (1.0 + c + c * c / 3.0) * torch.exp(-c)
    if kernel == "matern32":
        c = math.sqrt(3.0) * s
        return signal_var * (1.0 + c) * torch.exp(-c)
    raise ValueError(f"unknown GP kernel: {kernel!r}")


def _jitter(dtype) -> float:
    # f32 Cholesky needs a larger floor: a near-noise-free MLE solution
    # leaves K within f32 rounding of singular
    return 1e-4 if dtype == torch.float32 else 1e-6


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _masked_kernel_matrix(r, mask, kernel, ls, sv, nv):
    """Covariance from the (n, n) distances ``r``, with padded rows/cols
    replaced by identity: the pad block decouples exactly (its Cholesky rows
    are e_i, its logdet contribution 0, its alpha entries y_pad = 0), so
    NLML and posterior over the valid points equal the unpadded problem's."""
    n = r.shape[0]
    k = gp_kernel_eval(r, kernel, ls, sv)
    k = k + (nv + _jitter(r.dtype) * sv) * _eye(n, r)
    if mask is None:
        return k
    return mask[:, None] * k * mask[None, :] + torch.diag(1.0 - mask)


def _cholesky(k: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the matrix is not positive
    definite (JAX's answer there), without a synchronisation."""
    chol, info = torch.linalg.cholesky_ex(k)
    return torch.where(info == 0, chol, torch.nan)


def _solve_alpha(chol, y):
    return torch.cholesky_solve(y[:, None], chol)[:, 0]


def _nlml(log_params, r, y, kernel, mask=None):
    """Negative log marginal likelihood / n in log-parameter space, from
    the training distances ``r``."""
    ls, sv, nv = torch.exp(log_params)
    k = _masked_kernel_matrix(r, mask, kernel, ls, sv, nv)
    n_eff = r.shape[0] if mask is None else torch.sum(mask)
    if mask is not None:
        y = y * mask
    chol = _cholesky(k)
    alpha = _solve_alpha(chol, y)
    data_fit = 0.5 * torch.sum(y * alpha)
    log_det = torch.sum(torch.log(torch.diagonal(chol)))
    return (data_fit + log_det + 0.5 * n_eff * _LOG_2PI) / n_eff


def _gp_fit(r, y, log_params, kernel, mask=None):
    ls, sv, nv = torch.exp(log_params)
    k = _masked_kernel_matrix(r, mask, kernel, ls, sv, nv)
    if mask is not None:
        y = y * mask
    chol = _cholesky(k)
    return chol, _solve_alpha(chol, y)


def _cross_cov(xq, x_train, log_params, kernel, mask):
    ls, sv, _nv = torch.exp(log_params)
    k_q = gp_kernel_eval(pairwise_dists(xq, x_train), kernel, ls, sv)
    if mask is not None:
        k_q = k_q * mask[None, :]
    return k_q, sv


def _gp_predict(x_train, chol, alpha, log_params, xq, kernel, mask=None):
    k_q, sv = _cross_cov(xq, x_train, log_params, kernel, mask)
    mean = k_q @ alpha
    v = torch.linalg.solve_triangular(chol, k_q.mT, upper=False)
    var = sv - torch.sum(v * v, dim=0)
    return mean, torch.clamp_min(var, 0.0)


def _minimize(cost, init: torch.Tensor) -> torch.Tensor:
    """BFGS minimum of ``cost``, or ``init`` where it is not finite."""
    lp, _ = _bfgs(cost, init)
    return torch.where(torch.isfinite(lp).all(), lp, init)


class GpRegressor:
    """Exact GP regression with optional hyperparameter MLE.

    y is centered internally. predict returns (mean, var) with var the
    latent-function variance (add ``noise_var`` for observation variance).
    ``device`` is where numpy inputs to ``fit`` go (default
    ``utils.device.default_device()``); tensors stay where they are, and
    the hyperparameters take the data's dtype.
    """

    def __init__(self, kernel: str = "rbf", length_scale: float = 1.0,
                 signal_var: float = 1.0, noise_var: float = 1e-4,
                 device=None):
        self.kernel = kernel
        self.length_scale = float(length_scale)
        self.signal_var = float(signal_var)
        self.noise_var = float(noise_var)
        self._device = device
        self.x_train = None

    def _log_params(self, like=None):
        like = self.x_train if like is None else like
        return torch.log(torch.tensor(
            [self.length_scale, self.signal_var, self.noise_var],
            dtype=like.dtype, device=like.device))

    def fit(self, x, y, optimize_hypers: bool = True,
            pad_to: int | None = None):
        """Fit on (x, y). ``pad_to``: pad the training set to this size
        with exactly-masked rows; the posterior and NLML equal the unpadded
        fit's (identity-row decoupling, see _masked_kernel_matrix)."""
        x = as_tensor(x, device=self._device)
        y = as_tensor(y, device=x.device, dtype=x.dtype)
        if y.ndim == 2:
            y = y[:, 0]
        self._y_mean = torch.mean(y)
        yc = y - self._y_mean
        mask = None
        if pad_to is not None:
            n = x.shape[0]
            if pad_to < n:
                raise ValueError(f"pad_to={pad_to} < n={n}")
            pad = int(pad_to) - n
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            yc = torch.cat([yc, yc.new_zeros(pad)])
            mask = torch.cat([x.new_ones(n), x.new_zeros(pad)])
        r = pairwise_dists(x, x)
        if optimize_hypers:
            lp = _minimize(lambda p: _nlml(p, r, yc, self.kernel, mask),
                           self._log_params(x))
            self.length_scale, self.signal_var, self.noise_var = (
                float(v) for v in torch.exp(lp))
        self.x_train = x
        self._yc = yc
        self._mask = mask
        self._chol, self._alpha = _gp_fit(r, yc, self._log_params(),
                                          self.kernel, mask)
        return self

    def _query(self, xq) -> torch.Tensor:
        return as_tensor(xq, device=self.x_train.device,
                         dtype=self.x_train.dtype)

    def predict(self, xq, return_var: bool = True):
        """(mean, var) at the query rows, in blocks of queries whose cross
        covariance holds at most ``_QUERY_BLOCK_ELEMS`` entries: its
        temporaries and the triangular solve's output stay a few of those
        blocks (65,536 queries against 8,192 points in f64 would otherwise
        hold about six 4.3 GB matrices at once)."""
        xq = self._query(xq)
        step = max(1, _QUERY_BLOCK_ELEMS // self.x_train.shape[0])
        parts = [_gp_predict(self.x_train, self._chol, self._alpha,
                             self._log_params(), xq[i:i + step], self.kernel,
                             getattr(self, "_mask", None))
                 for i in range(0, xq.shape[0], step)]
        mean, var = (parts[0] if len(parts) == 1 else
                     (torch.cat([p[0] for p in parts]),
                      torch.cat([p[1] for p in parts])))
        mean = mean + self._y_mean
        return (mean, var) if return_var else mean

    def predict_cov(self, xq):
        """Full posterior covariance at the query points (n_q, n_q);
        ``predict`` returns only its diagonal."""
        xq = self._query(xq)
        lp = self._log_params()
        k_q, sv = _cross_cov(xq, self.x_train, lp, self.kernel,
                             getattr(self, "_mask", None))
        ls = torch.exp(lp[0])
        k_qq = gp_kernel_eval(pairwise_dists(xq, xq), self.kernel, ls, sv)
        v = torch.linalg.solve_triangular(self._chol, k_q.mT, upper=False)
        cov = k_qq - v.mT @ v
        return 0.5 * (cov + cov.mT)

    def sample_posterior(self, xq, n_samples: int, key=0):
        """(n_samples, n_q) coherent posterior function draws at xq. The
        standard normals come from ``ops.random_svd._draw_sketch``."""
        xq = self._query(xq)
        mean = self.predict(xq, return_var=False)
        cov = self.predict_cov(xq)
        # the posterior covariance can be numerically semidefinite: jitter
        # the Cholesky, scaled to the covariance's own magnitude
        n_q = cov.shape[0]
        scale = torch.clamp_min(torch.max(torch.diagonal(cov)),
                                torch.finfo(cov.dtype).tiny)
        chol = torch.linalg.cholesky(
            cov + _jitter(cov.dtype) * scale * _eye(n_q, cov))
        z = _rsvd._draw_sketch(key, (int(n_samples), n_q), cov.dtype,
                               cov.device)
        return mean[None, :] + z @ chol.mT

    def log_marginal_likelihood(self) -> float:
        mask = getattr(self, "_mask", None)
        n = (self.x_train.shape[0] if mask is None
             else float(torch.sum(mask)))
        r = pairwise_dists(self.x_train, self.x_train)
        return -float(_nlml(self._log_params(), r, self._yc, self.kernel,
                            mask)) * n


# ---------------------------------------------------------------------------
# Sparse GP (inducing points) for large N

def _draw_inducing(key, n: int, m: int, device) -> torch.Tensor:
    """``m`` distinct row indices of ``n``, uniformly at random: the one
    place the sparse GP draws (the JAX package's
    ``jax.random.choice(key, n, (m,), replace=False)``)."""
    gen = as_generator(key, device)
    return torch.randperm(n, generator=gen, device=device)[:m]


def _sgpr_factors(r_mm, r_mn, y, log_params, kernel, sharded=None):
    """Titsias (2009) variational sparse GP factors from the distances
    r_mm (m, m) and r_mn (m, n).

    Returns (l_mm, l_b, a, c) with
      l_mm = chol(K_mm + jitter), a = l_mm^-1 K_mn / sigma,
      l_b = chol(I + a a^T),      c = l_b^-1 a y / sigma.

    ``sharded`` = (mesh, axis) when r_mn and y are this rank's columns and
    rows of a row-sharded fit: a stays local, a a^T and a y are psummed,
    and l_b is the Cholesky factor of I + a a^T; the replicated values that
    meet the local columns go through ``parallel.mesh._to_local`` (see
    there for the gradients).
    """
    ls, sv, nv = torch.exp(log_params)
    m = r_mm.shape[0]
    sigma = torch.sqrt(nv)
    k_mm = gp_kernel_eval(r_mm, kernel, ls, sv)
    k_mm = k_mm + _jitter(r_mm.dtype) * sv * _eye(m, r_mm)
    l_mm = _cholesky(k_mm)
    ls_l, sv_l, l_mm_l, sigma_l = ls, sv, l_mm, sigma
    if sharded is not None:
        from corrla_rs_tpu_torch.parallel.mesh import _to_local

        ls_l, sv_l, l_mm_l, sigma_l = (_to_local(v, *sharded)
                                       for v in (ls, sv, l_mm, sigma))
    k_mn = gp_kernel_eval(r_mn, kernel, ls_l, sv_l)
    a = torch.linalg.solve_triangular(l_mm_l, k_mn, upper=False) / sigma_l
    # chol(B) with B = I + A A^T through QR of [A^T; I] (R^T R = B):
    # forming B would square the condition number
    if sharded is None:
        stack = torch.cat([a.mT, _eye(m, a)], dim=0)
        rr = torch.linalg.qr(stack, mode="reduced").R
        sgn = torch.sign(torch.diagonal(rr))
        sgn = torch.where(sgn == 0, 1.0, sgn)
        l_b = (rr * sgn[:, None]).mT
        ay = a @ y
    else:
        from corrla_rs_tpu_torch.parallel.mesh import _psum_grad

        # one psum of [A A^T | A y]; B is the identity plus a PSD matrix,
        # so its Cholesky is stable. A local QR of A^T (a TSQR) would be
        # exact too, but its backward divides by a rank's R, which is near
        # singular where the inducing points lie far from the rank's rows
        gay = _psum_grad(a @ torch.cat([a.mT, y[:, None]], dim=1), *sharded)
        ay = gay[:, m]
        l_b = _cholesky(gay[:, :m] + _eye(m, a))
    c = torch.linalg.solve_triangular(l_b, ay[:, None],
                                      upper=False)[:, 0] / sigma
    return l_mm, l_b, a, c


def _sgpr_neg_elbo(log_params, r_mm, r_mn, y, kernel, sharded=None):
    """Negative Titsias ELBO / n, the sparse analogue of _nlml.
    ``sharded``: see ``_sgpr_factors``; n, y^T y and the trace's sum of
    a^2 are then psummed."""
    _ls, sv, nv = torch.exp(log_params)
    _l_mm, l_b, a, c = _sgpr_factors(r_mm, r_mn, y, log_params, kernel,
                                     sharded)
    sums = torch.stack([torch.sum(y * y), torch.sum(a * a)])
    n = r_mn.shape[1]
    if sharded is not None:
        from corrla_rs_tpu_torch.parallel.mesh import _psum_grad

        sums = _psum_grad(sums, *sharded)
        n = n * _size(sharded)
    quad = sums[0] / nv - torch.sum(c * c)
    logdet = n * torch.log(nv) + 2.0 * torch.sum(
        torch.log(torch.diagonal(l_b)))
    trace = (n * sv - nv * sums[1]) / nv
    return 0.5 * (n * _LOG_2PI + logdet + quad + trace) / n


def _size(sharded) -> int:
    from corrla_rs_tpu_torch.parallel.mesh import _size as size

    return size(*sharded)


def _sgpr_predict(x_ind, l_mm, l_b, c, log_params, xq, kernel):
    ls, sv, _nv = torch.exp(log_params)
    k_mq = gp_kernel_eval(pairwise_dists(x_ind, xq), kernel, ls, sv)
    a_q = torch.linalg.solve_triangular(l_mm, k_mq, upper=False)
    b_q = torch.linalg.solve_triangular(l_b, a_q, upper=False)
    mean = b_q.mT @ c
    var = sv - torch.sum(a_q * a_q, dim=0) + torch.sum(b_q * b_q, dim=0)
    return mean, torch.clamp_min(var, 0.0)


class SparseGpRegressor:
    """Sparse variational GP (Titsias 2009 SGPR) for large training sets.

    m inducing points make fitting O(n m^2) and prediction O(m^2).
    Hyperparameters optimise the collapsed variational ELBO on
    standardised targets, from the constructor's values read in the
    standardised space; the fitted values are stored in raw-y units.

    inducing: int (that many training points, chosen uniformly at random
    with ``key`` through ``_draw_inducing``) or an (m, d) array of explicit
    locations. ``device`` is where numpy inputs to ``fit`` go.

    ``fit`` takes x as a row-sharded DTensor (``Shard(0)`` on a 1-D mesh;
    every rank calls) and y sharded the same way or whole on every rank.
    K_mn is then the kernel matrix of each rank's rows, and the ELBO's
    reductions over the samples are psums and a TSQR (``_sgpr_factors``);
    the drawn inducing rows reach every rank through one psum of a
    zero-filled (m, d) block. BFGS runs on every rank on equal values;
    the fitted model and ``predict`` are replicated.
    """

    # the 1-D mesh of a fit on row-sharded data
    _mesh = None

    @property
    def _sharded(self):
        """(mesh, axis) of a sharded fit, else None."""
        mesh = self._mesh
        return None if mesh is None else (mesh, mesh.mesh_dim_names[0])

    # class-level defaults: checkpoints written before these attributes
    # existed restore without __init__
    _y_scale = 1.0
    _init_spec = (1.0, 1.0, 1e-2)

    def __init__(self, kernel: str = "rbf", length_scale: float = 1.0,
                 signal_var: float = 1.0, noise_var: float = 1e-2,
                 inducing=128, key=0, device=None):
        self.kernel = kernel
        self.length_scale = float(length_scale)
        self.signal_var = float(signal_var)
        self.noise_var = float(noise_var)
        # every fit restarts from the constructor's values
        self._init_spec = (
            float(length_scale), float(signal_var), float(noise_var)
        )
        self._inducing_spec = inducing
        self._key = key
        self._device = device
        self.x_ind = None

    def _log_params_std(self):
        """Hyperparameters in standardised-y units (the internal fit
        space): variances scale with y^2, the length scale does not."""
        s2 = float(self._y_scale) ** 2
        return torch.log(torch.tensor(
            [self.length_scale, self.signal_var / s2, self.noise_var / s2],
            dtype=self.x_ind.dtype, device=self.x_ind.device))

    def fit(self, x, y, optimize_hypers: bool = True):
        from corrla_rs_tpu_torch.parallel.mesh import rows_of_dtensor

        rows = rows_of_dtensor(x)
        vars(self).pop("_mesh", None)
        if rows is not None:
            return self._fit_sharded(rows, y, optimize_hypers)
        x = as_tensor(x, device=self._device)
        y = as_tensor(y, device=x.device, dtype=x.dtype)
        if y.ndim == 2:
            y = y[:, 0]
        self._y_mean = torch.mean(y)
        # standardise y for the fit: the ELBO's degenerate optimum at
        # signal_var -> 0 catches BFGS when the init is mis-scaled
        self._y_scale = torch.clamp_min(torch.std(y, correction=0),
                                        torch.finfo(y.dtype).tiny)
        yc = (y - self._y_mean) / self._y_scale
        if isinstance(self._inducing_spec, int):
            m = min(self._inducing_spec, x.shape[0])
            self.x_ind = x[_draw_inducing(self._key, x.shape[0], m,
                                          x.device)]
        else:
            self.x_ind = as_tensor(self._inducing_spec, device=x.device,
                                   dtype=x.dtype)
        return self._fit_factors(x, yc, optimize_hypers)

    def _fit_sharded(self, rows, y, optimize_hypers):
        from corrla_rs_tpu_torch.parallel.mesh import _coord, _local, _psum

        x_l, (n, _d), mesh, axis = rows
        self._mesh = mesh
        y_l, _ = _local(y, mesh, axis, device=x_l.device, dtype=x_l.dtype)
        if y_l.ndim == 2:
            y_l = y_l[:, 0]
        self._y_mean = _psum(torch.sum(y_l), mesh, axis) / n
        self._y_scale = torch.clamp_min(
            torch.sqrt(_psum(torch.sum((y_l - self._y_mean) ** 2), mesh,
                             axis) / n),
            torch.finfo(y_l.dtype).tiny)
        yc = (y_l - self._y_mean) / self._y_scale
        if isinstance(self._inducing_spec, int):
            m = min(self._inducing_spec, n)
            idx = _draw_inducing(self._key, n, m, x_l.device) \
                - _coord(mesh, axis) * x_l.shape[0]
            mine = ((idx >= 0) & (idx < x_l.shape[0]))[:, None]
            own = x_l[idx.clamp(0, x_l.shape[0] - 1)]
            # each rank adds the rows it owns to a zero block: exact
            self.x_ind = _psum(torch.where(mine, own, torch.zeros_like(own)),
                               mesh, axis)
        else:
            self.x_ind = as_tensor(self._inducing_spec, device=x_l.device,
                                   dtype=x_l.dtype)
        return self._fit_factors(x_l, yc, optimize_hypers)

    def _fit_factors(self, x, yc, optimize_hypers):
        """The distances, the hyperparameters' MLE and the factors, from
        the training points ``x`` (this rank's rows of a sharded fit)."""
        r_mm = pairwise_dists(self.x_ind, self.x_ind)
        r_mn = pairwise_dists(self.x_ind, x)
        if optimize_hypers:
            init = torch.log(torch.tensor(self._init_spec, dtype=x.dtype,
                                          device=x.device))
            lp = _minimize(
                lambda p: _sgpr_neg_elbo(p, r_mm, r_mn, yc, self.kernel,
                                         self._sharded),
                init)
            s2 = float(self._y_scale) ** 2
            ls, sv, nv = (float(v) for v in torch.exp(lp))
            self.length_scale = ls
            self.signal_var = sv * s2
            self.noise_var = nv * s2
        self._yc = yc
        self.x_train = x
        l_mm, l_b, _a, c = _sgpr_factors(r_mm, r_mn, yc,
                                         self._log_params_std(), self.kernel,
                                         self._sharded)
        self._l_mm, self._l_b, self._c = l_mm, l_b, c
        return self

    def predict(self, xq, return_var: bool = True):
        xq = as_tensor(xq, device=self.x_ind.device, dtype=self.x_ind.dtype)
        mean, var = _sgpr_predict(
            self.x_ind, self._l_mm, self._l_b, self._c,
            self._log_params_std(), xq, self.kernel,
        )
        mean = mean * self._y_scale + self._y_mean
        var = var * self._y_scale ** 2
        return (mean, var) if return_var else mean

    def elbo(self) -> float:
        """Collapsed variational lower bound on log p(y_standardised)
        (total, not /n; the fit-space objective). After a sharded fit every
        rank calls."""
        n = self.x_train.shape[0] * (1 if self._sharded is None
                                     else _size(self._sharded))
        r_mm = pairwise_dists(self.x_ind, self.x_ind)
        r_mn = pairwise_dists(self.x_ind, self.x_train)
        return -float(_sgpr_neg_elbo(self._log_params_std(), r_mm, r_mn,
                                     self._yc, self.kernel,
                                     self._sharded)) * n
