"""Laplace approximation: MAP + Hessian uncertainty + evidence.

Counterpart of ``corrla_rs_tpu/ops/laplace.py``. The cheap deterministic
member of the Bayesian toolchain (DEMC / DREAM / stretch / HMC sample
exactly; SMC integrates exactly; this approximates): fit a Gaussian
N(x_map, H^-1) at the posterior mode, with the classic Laplace evidence

    log Z ~= ln p(x_map) + d/2 log(2 pi) - 1/2 log det H,

H = -grad^2 ln p(x_map). Exact for Gaussian posteriors; the standard
calibration baseline and initializer for the samplers (start chains from
N(x_map, H^-1) draws instead of a guess).

The mode comes from the port's dense BFGS (``ops.optimize._bfgs``), one
descent a restart in a host loop; its iterates differ from
``jax.scipy.optimize.minimize``'s, so compare fits on the mode and the
covariance. The Hessian is ``torch.func.hessian`` (exact, no finite
differences: the reference finite-diffs every gradient it needs,
univariate_rv.rs:136-154), and draws are one triangular product. The
restarts' noise and the draws are standard normals from the port's one
normal-draw seam, ``ops.random_svd._draw_sketch``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.ops.optimize import _bfgs, _param

__all__ = ["LaplaceResult", "laplace_approx", "laplace_sample"]

_LOG_2PI = math.log(2.0 * math.pi)
# a restart counts as converged when no entry of the gradient exceeds this
_GTOL = 1e-5


class LaplaceResult(NamedTuple):
    x_map: torch.Tensor       # (d,) posterior mode
    cov: torch.Tensor         # (d, d) H^-1 at the mode
    chol_cov: torch.Tensor    # (d, d) lower Cholesky of cov
    log_evidence: float       # Laplace estimate of the log integral
    ln_post_map: float        # ln p at the mode
    converged: bool           # the winning restart's gradient is below 1e-5
    x_map_all: torch.Tensor   # (n_restarts, d) every restart's endpoint


def laplace_approx(ln_post_fn: Callable, x0, n_restarts: int = 1,
                   spread: float = 1.0, key=0) -> LaplaceResult:
    """Laplace-approximate the density exp(ln_post_fn).

    ln_post_fn: UNNORMALIZED log posterior of a (d,) point (the contract of
    every sampler in the library).
    x0: (d,) starting point, or (n, d) explicit starts (overrides
    n_restarts); a floating tensor keeps its dtype and device, anything
    else becomes float64 on ``utils.device.default_device()``.
    n_restarts: extra BFGS starts drawn N(x0, spread^2 I); the
    highest-posterior endpoint wins (multimodal posteriors keep the dominant
    mode). key: int seed or ``torch.Generator`` of those draws.
    """
    x0 = _param(x0)
    if x0.ndim == 1:
        d = x0.shape[0]
        starts = x0[None]
        if n_restarts > 1:
            noise = spread * _rsvd._draw_sketch(key, (n_restarts - 1, d),
                                                x0.dtype, x0.device)
            starts = torch.cat([starts, x0[None] + noise])
    else:
        starts = x0
        d = starts.shape[1]

    def neg(x):
        return -ln_post_fn(x)

    ends = [_bfgs(neg, s, gtol=_GTOL) for s in starts]
    xs = torch.stack([p for p, _ in ends])
    funs = torch.stack([f for _, f in ends])
    funs = torch.where(torch.isfinite(funs), funs, math.inf)
    best = torch.argmin(funs)
    x_map = xs[best]
    h = -torch.func.hessian(ln_post_fn)(x_map)
    h = 0.5 * (h + h.mT)
    # guard: a saddle or an indefinite H means the "mode" is not one
    eigs = torch.linalg.eigvalsh(h)
    if not bool(torch.all(eigs > 0)):
        raise ValueError(
            "Hessian at the optimum is not positive definite "
            f"(eigs {eigs.tolist()}); the posterior has no proper "
            "mode there: check ln_post_fn or provide better starts")
    cov = torch.linalg.inv(h)
    cov = 0.5 * (cov + cov.mT)
    g_max = torch.func.grad(neg)(x_map).abs().max()
    log_det_h = 2.0 * torch.sum(torch.log(torch.diagonal(
        torch.linalg.cholesky(h))))
    lnp_map, log_det, g_max = torch.stack([
        ln_post_fn(x_map).double(), log_det_h.double(),
        g_max.double()]).tolist()
    return LaplaceResult(
        x_map=x_map, cov=cov, chol_cov=torch.linalg.cholesky(cov),
        log_evidence=lnp_map + 0.5 * d * _LOG_2PI - 0.5 * log_det,
        ln_post_map=lnp_map, converged=g_max <= _GTOL, x_map_all=xs,
    )


def laplace_sample(result: LaplaceResult, n_samples: int, key=0):
    """Draw (n_samples, d) from the fitted Gaussian N(x_map, cov), e.g.
    overdispersed-but-informed chain initializations for the samplers.
    ``key`` is an int seed or a ``torch.Generator``."""
    x_map = result.x_map
    z = _rsvd._draw_sketch(key, (int(n_samples), x_map.shape[0]),
                           x_map.dtype, x_map.device)
    return x_map[None, :] + z @ result.chol_cov.mT
