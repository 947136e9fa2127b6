"""CMA-ES: covariance matrix adaptation evolution strategy (extension).

Counterpart of ``corrla_rs_tpu/ops/cma.py``: the standard (mu/mu_w, lambda)
algorithm of Hansen & Ostermeier (2001) / Hansen's 2016 tutorial, with
rank-mu and rank-one covariance updates, cumulative step-size adaptation
(CSA) and log-decreasing recombination weights. It adapts a full
covariance to the objective's local geometry, where PSO and isotropic
strategies stall on ill-conditioned valleys.

A generation is one batched evaluation of the population plus small-matrix
updates (one (d, d) eigh for the sampling transform), on the device of
``x0`` (numpy goes to ``device=``, default ``utils.device.default_device()``);
the generations are a host loop that reads nothing back until the end. The
population is evaluated through ``torch.func.vmap(fn)``; a callable that
vmap cannot trace (the errors ``ops.quadrature._UNTRACEABLE`` names, and
``TypeError``) is evaluated point by point on float64 host rows, where the
JAX package falls back to its eager loop; any other error propagates. The
normals of every generation come from one seam, ``_draw_normals``, which the
parity tests fill with the JAX package's draws from its split keys.

On a mesh (``mesh=``) the population is sharded and every rank makes the
same call: each generation's candidates come from the normals drawn whole
on every rank, each rank evaluates its rows with ``vmap(fn)``, the (pop,)
fitness vector is all-gathered, and the distribution update runs
replicated on the whole population, so the sharded run is the
single-device one. An objective that vmap cannot trace is refused there:
its host loop would evaluate every candidate on every rank.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from corrla_rs_tpu_torch.ops.quadrature import _untraceable
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["CmaResult", "cma_es"]


class CmaResult(NamedTuple):
    x_best: torch.Tensor      # (d,) best point ever evaluated
    f_best: float
    mean: torch.Tensor        # (d,) final distribution mean
    sigma: float              # final global step size
    history: torch.Tensor     # (n_gens,) per-generation best f
    n_evals: int


def _draw_normals(key, n_gens: int, pop: int, d: int, dtype, device):
    """(n_gens, pop, d) standard normals: every generation's candidates'
    randomness in one call."""
    gen = as_generator(key, device)
    return torch.randn((int(n_gens), pop, d), generator=gen, dtype=dtype,
                       device=device)


def _params(d: int, pop: int):
    mu = pop // 2
    w = np.log(mu + 0.5) - np.log(np.arange(1, mu + 1))
    w = w / w.sum()
    mu_eff = 1.0 / np.sum(w ** 2)
    c_sigma = (mu_eff + 2.0) / (d + mu_eff + 5.0)
    d_sigma = 1.0 + 2.0 * max(0.0, np.sqrt((mu_eff - 1.0) / (d + 1.0))
                              - 1.0) + c_sigma
    c_c = (4.0 + mu_eff / d) / (d + 4.0 + 2.0 * mu_eff / d)
    c_1 = 2.0 / ((d + 1.3) ** 2 + mu_eff)
    c_mu = min(1.0 - c_1,
               2.0 * (mu_eff - 2.0 + 1.0 / mu_eff)
               / ((d + 2.0) ** 2 + mu_eff))
    chi_n = np.sqrt(d) * (1.0 - 1.0 / (4.0 * d) + 1.0 / (21.0 * d * d))
    return (mu, w, float(mu_eff), float(c_sigma), float(d_sigma),
            float(c_c), float(c_1), float(c_mu), float(chi_n))


def _population_evaluator(fn, xs, traced_only: bool = False):
    """(evaluate, fs of ``xs``): ``torch.func.vmap(fn)`` where vmap can
    trace ``fn``, else a loop over float64 host rows (``traced_only``:
    a ``ValueError`` instead)."""
    batched = torch.func.vmap(fn)
    try:
        return batched, as_tensor(batched(xs), device=xs.device).reshape(-1)
    except (RuntimeError, TypeError) as err:
        if not _untraceable(err):
            raise
        if traced_only:
            raise ValueError(
                "cma_es(mesh=) needs an objective that torch.func.vmap "
                "can trace (vmap-traceable): the per-point host loop "
                "would evaluate every candidate on every rank") from err

    def one_by_one(points):
        vals = [float(fn(p)) for p in points.detach().cpu().numpy()]
        return torch.as_tensor(vals, dtype=points.dtype, device=points.device)

    return one_by_one, one_by_one(xs)


def cma_es(fn: Callable, x0, sigma0: float = 0.5, n_gens: int = 200,
           pop_size: int | None = None, key=0,
           bounds=None, mesh=None, axis_name=None, device=None) -> CmaResult:
    """Minimize ``fn`` from ``x0`` with initial step scale ``sigma0``.

    fn: (d,) -> scalar, written for one point; the population is evaluated
    through ``torch.func.vmap(fn)``, or point by point on host rows when
    vmap cannot trace ``fn`` (see the module docstring). The search runs
    in float64 on ``x0``'s device (numpy ``x0`` goes to ``device``).
    bounds: optional (d, 2) box; candidates are clipped before evaluation
    (the distribution itself is unconstrained). ``mesh``/``axis_name``:
    shard the candidate evaluations over the mesh axis (see the module
    docstring; the axis size must divide the population, and ``fn`` must
    be vmap-traceable); every result is replicated.
    """
    x0 = as_tensor(x0, device=device, dtype=torch.float64)
    dev, dtype = x0.device, x0.dtype
    d = x0.shape[0]
    pop = int(pop_size) if pop_size else 4 + int(3 * np.log(d))
    pop = max(pop, 4)
    rows = slice(None)
    if mesh is not None:
        from corrla_rs_tpu_torch.parallel.mesh import _all_gather, _members

        axis, rows = _members(mesh, axis_name, pop, "pop_size")
    (mu, w_host, mu_eff, c_sigma, d_sigma, c_c, c_1, c_mu,
     chi_n) = _params(d, pop)
    w = torch.as_tensor(w_host, dtype=dtype, device=dev)
    lo = hi = None
    if bounds is not None:
        b = torch.as_tensor(np.asarray(bounds, np.float64), dtype=dtype,
                            device=dev)
        lo, hi = b[:, 0], b[:, 1]

    normals = _draw_normals(key, int(n_gens), pop, d, dtype, dev)
    mean = x0
    sigma = torch.as_tensor(float(sigma0), dtype=dtype, device=dev)
    cov = torch.eye(d, dtype=dtype, device=dev)
    p_sig = torch.zeros(d, dtype=dtype, device=dev)
    p_c = torch.zeros(d, dtype=dtype, device=dev)
    x_best = x0
    f_best = torch.as_tensor(np.inf, dtype=dtype, device=dev)
    evaluate = None
    hist = []
    for g in range(int(n_gens)):
        # sampling transform from the eigendecomposition (also gives
        # C^-1/2 for the CSA path length)
        eigval, eigvec = torch.linalg.eigh(cov)
        eigval = eigval.clamp_min(1e-20)
        sq = eigvec * torch.sqrt(eigval)[None, :]          # C^1/2
        inv_sq = eigvec * (1.0 / torch.sqrt(eigval))[None, :]
        y = normals[g] @ sq.mT                             # N(0, C)
        xs = mean[None, :] + sigma * y
        if lo is not None:
            xs = torch.clamp(xs, lo[None, :], hi[None, :])
            y = (xs - mean[None, :]) / sigma
        if evaluate is None:
            evaluate, fs = _population_evaluator(fn, xs[rows],
                                                 mesh is not None)
        else:
            fs = evaluate(xs[rows])
        fs = fs.to(dtype)
        if mesh is not None:
            fs = _all_gather(fs, mesh, axis)
        order = torch.argsort(fs, stable=True)
        y_sel = y[order[:mu]]                              # (mu, d)
        y_w = w @ y_sel                                    # (d,)
        mean = mean + sigma * y_w
        # CSA: C^-1/2 y_w = V diag(1/sqrt(lam)) V^T y_w
        whitened = inv_sq @ (eigvec.mT @ y_w)
        p_sig = ((1.0 - c_sigma) * p_sig
                 + np.sqrt(c_sigma * (2.0 - c_sigma) * mu_eff) * whitened)
        norm_sig = torch.linalg.vector_norm(p_sig)
        sigma = sigma * torch.exp((c_sigma / d_sigma)
                                  * (norm_sig / chi_n - 1.0))
        # rank-one path (with stall guard h_sigma)
        ngen = g + 1.0
        h_sig = (norm_sig / np.sqrt(1.0 - (1.0 - c_sigma) ** (2.0 * ngen))
                 < (1.4 + 2.0 / (d + 1.0)) * chi_n).to(dtype)
        p_c = ((1.0 - c_c) * p_c
               + h_sig * np.sqrt(c_c * (2.0 - c_c) * mu_eff) * y_w)
        rank_mu = torch.einsum("i,ij,ik->jk", w, y_sel, y_sel)
        cov = ((1.0 - c_1 - c_mu) * cov
               + c_1 * (torch.outer(p_c, p_c)
                        + (1.0 - h_sig) * c_c * (2.0 - c_c) * cov)
               + c_mu * rank_mu)
        cov = 0.5 * (cov + cov.mT)
        # best-ever tracking
        i0 = order[0]
        better = fs[i0] < f_best
        x_best = torch.where(better, xs[i0], x_best)
        f_best = torch.where(better, fs[i0], f_best)
        hist.append(fs[i0])
    history = torch.stack(hist) if hist else x0.new_zeros(0)
    return CmaResult(x_best=x_best, f_best=float(f_best), mean=mean,
                     sigma=float(sigma), history=history,
                     n_evals=int(n_gens) * pop)
