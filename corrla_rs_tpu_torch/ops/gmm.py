"""Gaussian mixture models by EM (extension; no reference analogue).

Counterpart of ``corrla_rs_tpu/ops/gmm.py``. One EM iteration is three
dense batched steps on the data's device: the (n, k) log-density matrix
from batched triangular solves against every component's Cholesky factor
(65,536 points a solve: on the card one solve of 1,048,576 right-hand
sides came back wrong without an error), a logsumexp row reduction for the responsibilities, and the
weighted-Gram M-step. The JAX package runs a fixed number of iterations
(a ``lax.scan``) and freezes the parameters once the total log-likelihood
gain falls below ``tol``; here the iterations are a host loop with the
same freeze, which reads the frozen flag every ``_FROZEN_EVERY`` iterations
and stops once it is set: after the freeze nothing changes, so ``n_iter``
and the parameters are those of the full scan. k-means++ seeding picks
the first centre uniformly and each later one with probability
proportional to the squared distance from the chosen set.

Randomness goes through two seams: ``_draw_kmeanspp`` returns the first
centre's index and a (k, n) table of Gumbel noise (row j picks round j's
centre as the argmax of log-probabilities plus noise, which is
``jax.random.categorical``), and ``_draw_sample`` returns ``gmm_sample``'s
(n, k) Gumbel table and (n, d) standard normals. The parity tests fill
both from the JAX package's keys.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["GmmFit", "gmm_fit", "gmm_logpdf", "gmm_sample", "gmm_select"]

# EM iterations between two reads of the frozen flag
_FROZEN_EVERY = 8
# points a triangular solve takes at once: on the card one solve with
# 1,048,576 right-hand sides returned wrong values without an error
_SOLVE_POINTS = 1 << 16


class GmmFit(NamedTuple):
    """Fitted mixture: weights (k,), means (k, d), covs (k, d, d),
    log_likelihood (0-d, final total), n_iter (0-d, iterations until the
    freeze predicate fired), responsibilities (n, k) at the optimum,
    cov_type ('full' or 'diag', recorded so BIC/AIC count the right
    number of covariance parameters)."""
    weights: torch.Tensor
    means: torch.Tensor
    covs: torch.Tensor
    log_likelihood: torch.Tensor
    n_iter: torch.Tensor
    responsibilities: torch.Tensor
    cov_type: str = "full"

    @property
    def n_components(self) -> int:
        return int(self.weights.shape[0])

    def _n_params(self) -> int:
        k, d = self.means.shape
        # diag fits estimate k*d variances, full fits k*d*(d+1)/2
        cov_params = k * d if self.cov_type == "diag" \
            else k * d * (d + 1) // 2
        return k - 1 + k * d + cov_params

    def bic(self, n: int | None = None) -> float:
        """Bayesian information criterion (lower = better)."""
        n = int(self.responsibilities.shape[0]) if n is None else int(n)
        return float(self._n_params() * np.log(n)
                     - 2.0 * float(self.log_likelihood))

    def aic(self) -> float:
        return float(2.0 * self._n_params()
                     - 2.0 * float(self.log_likelihood))


def _draw_kmeanspp(key, n: int, k: int, dtype, device):
    """(first centre's index, (k, n) Gumbel noise; row j for round j,
    row 0 unused): all the randomness of one k-means++ seeding."""
    gen = as_generator(key, device)
    first = torch.randint(0, n, (), generator=gen, device=device)
    expo = torch.empty((k, n), dtype=dtype, device=device)
    return first, -torch.log(expo.exponential_(generator=gen))


def _draw_sample(key, n: int, k: int, d: int, dtype, device):
    """((n, k) Gumbel noise for the components, (n, d) standard
    normals): all the randomness of one ``gmm_sample``."""
    gen = as_generator(key, device)
    expo = torch.empty((n, k), dtype=dtype, device=device)
    gumbel = -torch.log(expo.exponential_(generator=gen))
    return gumbel, torch.randn((n, d), generator=gen, dtype=dtype,
                               device=device)


def _component_logpdf(x, means, chols):
    """(n, k) log N(x | mu_j, L_j L_j^T) by batched triangular solves
    (backward stable; no explicit inverse), ``_SOLVE_POINTS`` points a
    solve."""
    d = x.shape[1]
    z2 = []
    for lo in range(0, x.shape[0], _SOLVE_POINTS):
        xs = x[lo:lo + _SOLVE_POINTS]
        diff = (xs[None, :, :] - means[:, None, :]).mT    # (k, d, points)
        z = torch.linalg.solve_triangular(chols, diff, upper=False)
        z2.append((z * z).sum(dim=1))
    logdet = torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)).sum(-1)
    return (-0.5 * torch.cat(z2, dim=1) - logdet[:, None]
            - 0.5 * d * math.log(2.0 * math.pi)).mT       # (n, k)


class _Rows:
    """How the EM reaches the rows of x: all of them here (``sharded`` is
    None), or this rank's block of a row-sharded x. ``psum`` sums over the
    shards; ``row(i)`` is the global row i on every rank; ``argmax(v)`` is
    the global index of the largest entry of the sharded vector v, the
    lowest on a tie."""

    def __init__(self, x, n: int, sharded=None):
        self.x, self.n, self.sharded = x, n, sharded
        self.lo = 0
        if sharded is not None:
            from corrla_rs_tpu_torch.parallel.mesh import _coord

            self.lo = _coord(*sharded) * x.shape[0]

    def psum(self, t):
        if self.sharded is None:
            return t
        from corrla_rs_tpu_torch.parallel.mesh import _psum

        return _psum(t, *self.sharded)

    def row(self, i):
        if self.sharded is None:
            return self.x[i]
        # the owner adds its row to a zero block: an exact sum
        i = i - self.lo
        mine = (i >= 0) & (i < self.x.shape[0])
        own = self.x[i.clamp(0, self.x.shape[0] - 1)]
        return self.psum(torch.where(mine, own, torch.zeros_like(own)))

    def argmax(self, v):
        if self.sharded is None:
            return torch.argmax(v)
        from corrla_rs_tpu_torch.parallel.mesh import _all_gather

        j = torch.argmax(v)
        # f64 holds every index exactly
        pairs = _all_gather(torch.stack([v[j].double(),
                                         (j + self.lo).double()])[None],
                            *self.sharded)                      # (ranks, 2)
        # the first rank holding the maximum has the lowest index
        return pairs[torch.argmax(pairs[:, 0]), 1].long()


def _kmeanspp_init(key, rows: _Rows, k: int):
    x, n = rows.x, rows.n
    first, gumbel = _draw_kmeanspp(key, n, k, x.dtype, x.device)
    gumbel = gumbel[:, rows.lo:rows.lo + x.shape[0]]
    centers = x.new_zeros((k, x.shape[1]))
    c = rows.row(torch.as_tensor(first, device=x.device))
    centers[0] = c
    d2 = ((x - c) ** 2).sum(dim=1)
    tiny = torch.finfo(x.dtype).tiny
    for j in range(1, k):
        p = d2 / rows.psum(d2.sum()).clamp_min(tiny)
        c = rows.row(rows.argmax(torch.log(p + 1e-30) + gumbel[j]))
        centers[j] = c
        d2 = torch.minimum(d2, ((x - c) ** 2).sum(dim=1))
    return centers


def _e_step(rows: _Rows, w, means, covs):
    chols = torch.linalg.cholesky(covs)
    lp = _component_logpdf(rows.x, means, chols) + torch.log(w)
    norm = torch.logsumexp(lp, dim=1)
    return torch.exp(lp - norm[:, None]), rows.psum(norm.sum())


def _m_step(rows: _Rows, resp, cov_type: str, reg: float):
    x, n, d = rows.x, rows.n, rows.x.shape[1]
    nk = rows.psum(resp.sum(dim=0)) + 1e-12
    w = nk / n
    means = rows.psum(resp.mT @ x) / nk[:, None]
    diff = x[None, :, :] - means[:, None, :]              # (k, n, d)
    covs = rows.psum((diff * resp.mT[:, :, None]).mT @ diff) \
        / nk[:, None, None]
    if cov_type == "diag":
        covs = torch.diag_embed(torch.diagonal(covs, dim1=-2, dim2=-1))
    return w, means, covs + reg * torch.eye(d, dtype=x.dtype,
                                            device=x.device)


def _gmm_em(rows: _Rows, key, k: int, n_iter: int, cov_type: str,
            reg: float, tol: float):
    x, n, d = rows.x, rows.n, rows.x.shape[1]
    means = _kmeanspp_init(key, rows, k)
    if rows.sharded is None:
        var = x.var(dim=0, correction=0)
    else:
        mean = rows.psum(x.sum(dim=0)) / n
        var = rows.psum(((x - mean) ** 2).sum(dim=0)) / n
    covs = torch.diag(var + reg).expand(k, d, d)
    w = x.new_full((k,), 1.0 / k)
    ll_prev = x.new_tensor(-math.inf)
    frozen = torch.zeros((), dtype=torch.bool, device=x.device)
    it = torch.zeros((), dtype=torch.int64, device=x.device)
    for step in range(n_iter):
        resp, ll = _e_step(rows, w, means, covs)
        w_new, m_new, c_new = _m_step(rows, resp, cov_type, reg)
        # a non-finite ll_prev (the -inf start) always counts as improved
        improved = ~torch.isfinite(ll_prev) \
            | ((ll - ll_prev) > tol * ll_prev.abs())
        frozen = frozen | ~improved
        # once converged the parameters stay fixed, as the JAX scan keeps
        # them until its last step
        w = torch.where(frozen, w, w_new)
        means = torch.where(frozen, means, m_new)
        covs = torch.where(frozen, covs, c_new)
        it = it + (~frozen).long()
        ll_prev = ll
        if (step + 1) % _FROZEN_EVERY == 0 and bool(frozen):
            break
    resp, ll_final = _e_step(rows, w, means, covs)
    return w, means, covs, ll_final, it, resp


def gmm_fit(x, n_components: int, key=0, n_iter: int = 200,
            cov_type: str = "full", reg: float = 1e-6,
            tol: float = 1e-7, mesh=None, axis_name=None,
            device=None) -> GmmFit:
    """Fit a Gaussian mixture with EM (k-means++ init).

    x (n, d) data; n_components: mixture size k; key: int seed or
    ``torch.Generator`` for the init; n_iter: the number of iterations
    (an iteration freezes once the total log-likelihood gain drops below
    ``tol`` relative; check ``fit.n_iter``); cov_type 'full' or 'diag';
    reg: diagonal regularization added to every covariance. Numpy ``x``
    goes to ``device`` (default ``utils.device.default_device()``).
    ``mesh``/``axis_name``: a DeviceMesh (``parallel.mesh.make_mesh``;
    every rank calls) and the axis (default its first) the rows of x shard
    over (x a DTensor sharded so, or the full array every rank holds; the
    axis size must divide n). The E-step stays on each rank's rows, the
    M-step psums its statistics (nk, resp^T x, the weighted Grams), and the
    k-means++ seeding takes each centre's global argmax from the ranks'
    (value, index) pairs. The responsibilities come back a DTensor with
    ``Shard(0)``; the rest is replicated.

    Returns :class:`GmmFit`.
    """
    sharded = None
    if mesh is not None:
        from corrla_rs_tpu_torch.parallel.mesh import _axis, _local, _size

        axis = _axis(mesh, axis_name)
        shape = tuple(x.shape)
        n_dev = _size(mesh, axis)
        if shape[0] % n_dev:
            raise ValueError(
                f"mesh axis size ({n_dev}) must divide the row count "
                f"({shape[0]})")
        x, _ = _local(x, mesh, axis, device=device)
        sharded = (mesh, axis)
        n = shape[0]
    else:
        x = as_tensor(x, device=device)
        n = int(x.shape[0])
    if x.ndim == 1:
        x = x[:, None]
    k = int(n_components)
    if not 1 <= k <= n:
        raise ValueError(f"n_components must be in [1, {n}], got {k}")
    if cov_type not in ("full", "diag"):
        raise ValueError("cov_type must be 'full' or 'diag', got "
                         f"{cov_type!r}")
    w, means, covs, ll, it, resp = _gmm_em(_Rows(x, n, sharded), key, k,
                                           int(n_iter), cov_type, float(reg),
                                           float(tol))
    if sharded is not None:
        from corrla_rs_tpu_torch.parallel.mesh import _dtensor

        resp = _dtensor(resp, *sharded, 0, (n, k))
    return GmmFit(w, means, covs, ll, it, resp, cov_type)


def gmm_logpdf(fit: GmmFit, x):
    """Mixture log-density at query points x (m, d) -> (m,); numpy x goes
    to the fit's device."""
    x = as_tensor(x, device=fit.means.device, dtype=fit.means.dtype)
    if x.ndim == 1:
        x = x[:, None]
    chols = torch.linalg.cholesky(fit.covs)
    lp = _component_logpdf(x, fit.means, chols) + torch.log(fit.weights)
    return torch.logsumexp(lp, dim=1)


def gmm_sample(fit: GmmFit, key, n: int):
    """Draw n samples: a categorical component choice and
    Cholesky-colored normals (one gather, no per-sample branching), on
    the fit's device."""
    k, d = fit.means.shape
    gumbel, z = _draw_sample(key, int(n), k, d, fit.means.dtype,
                             fit.means.device)
    comp = torch.argmax(torch.log(fit.weights)[None, :] + gumbel, dim=1)
    chols = torch.linalg.cholesky(fit.covs)
    return fit.means[comp] + (chols[comp] @ z[:, :, None])[:, :, 0]


def gmm_select(x, k_range, key=0, criterion: str = "bic", **fit_kwargs):
    """Fit every k in k_range and return (best_fit, best_k, scores) by
    BIC (default) or AIC: the mixture-order analogue of the rank
    selectors in ops/rank_select."""
    if criterion not in ("bic", "aic"):
        raise ValueError(f"criterion must be 'bic' or 'aic', got "
                         f"{criterion!r}")
    scores = {}
    best = None
    for k in k_range:
        fit = gmm_fit(x, int(k), key=key, **fit_kwargs)
        s = fit.bic() if criterion == "bic" else fit.aic()
        scores[int(k)] = s
        if best is None or s < scores[best[1]]:
            best = (fit, int(k))
    return best[0], best[1], scores
