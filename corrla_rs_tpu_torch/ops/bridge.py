"""Bridge sampling: model evidence from EXISTING posterior draws.

Counterpart of ``corrla_rs_tpu/ops/bridge.py``. ``smc_sample``
(``ops/smc.py``) estimates the evidence by annealing a fresh particle
population; bridge sampling (Meng & Wong 1996; Gronau et al. 2017 tutorial)
recovers it from draws that ALREADY exist, e.g. the output of ``hmc_run``,
``nuts_run`` or ``stretch_run``, plus cheap draws from a fitted Gaussian
proposal:

    Z = E_prop[ q(x) h(x) ] / E_post[ g(x) h(x) ],

with the OPTIMAL bridge h (minimum relative MSE among all bridges) found by
the standard fixed-point iteration on log Z. The proposal is the
moment-matched Gaussian of the posterior draws (the tutorial's recipe).

The two log-density sweeps (one ``torch.func.vmap`` a set) are the only
device work; the fixed point runs on the host in f64 whatever the draws'
dtype, as in the JAX package: an iteration on the device would synchronise
a hundred times, and an f32 iterate jitters at eps |log Z|, so tight
tolerances would never be met. The proposal's standard normals come from
the port's one normal-draw seam, ``ops.random_svd._draw_sketch``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["BridgeResult", "bridge_sampling_evidence"]

_LOG_2PI = math.log(2.0 * math.pi)


class BridgeResult(NamedTuple):
    log_evidence: float
    n_iterations: int       # fixed-point iterations to convergence
    converged: bool
    proposal_mean: torch.Tensor
    proposal_chol: torch.Tensor


def _logsumexp(x: np.ndarray) -> float:
    """log sum exp that keeps an all -inf input at -inf (a max-shift alone
    gives nan there), so that a hopeless proposal surfaces as
    log_evidence = -inf."""
    top = np.max(x)
    if not np.isfinite(top):
        return float(top)
    return float(top + np.log(np.sum(np.exp(x - top))))


def bridge_sampling_evidence(ln_post_fn: Callable, posterior_draws,
                             n_proposal: int | None = None, key=0,
                             n_iters: int = 100, tol: float = 1e-10,
                             ) -> BridgeResult:
    """Estimate log Z = log integral exp(ln_post_fn) from posterior draws.

    ln_post_fn: UNNORMALIZED log posterior (the same callable the sampler
    targeted). posterior_draws (n, d): post-burn-in MCMC draws (thin enough
    to be roughly independent: autocorrelation inflates the error, not the
    bias). n_proposal: Gaussian-proposal draws (default: match n). key: int
    seed or ``torch.Generator`` of the proposal's draws.

    The first half of the posterior draws fits the moment-matched Gaussian
    proposal; the second half enters the bridge (Gronau et al.'s split
    avoids reusing draws for both, which biases Z upward).
    """
    draws = as_tensor(posterior_draws)
    if draws.ndim != 2:
        raise ValueError(f"posterior_draws must be (n, d), got "
                         f"{tuple(draws.shape)}")
    n, d = draws.shape
    if n < 4 * d:
        raise ValueError(f"need >= 4*d draws to fit the proposal, got "
                         f"{n} for d={d}")
    fit_half, use_half = draws[: n // 2], draws[n // 2:]
    mu = torch.mean(fit_half, dim=0)
    cov = torch.cov(fit_half.mT, correction=1).reshape(d, d)
    chol = torch.linalg.cholesky(
        cov + 1e-10 * torch.eye(d, dtype=cov.dtype, device=cov.device))
    log_det_half = torch.sum(torch.log(torch.diagonal(chol)))

    def ln_prop(x):
        z = torch.linalg.solve_triangular(chol, (x - mu).mT, upper=False)
        return -0.5 * torch.sum(z ** 2, dim=0) - 0.5 * d * _LOG_2PI \
            - log_det_half

    n1 = use_half.shape[0]
    n2 = int(n_proposal) if n_proposal else n1
    z_prop = _rsvd._draw_sketch(key, (n2, d), draws.dtype, draws.device)
    prop_draws = mu[None, :] + z_prop @ chol.mT

    # log ratios l = ln q_post - ln q_prop on both sets: the ONLY device
    # work; everything below is O(n)-scalar host algebra
    post_b = torch.func.vmap(ln_post_fn)
    l1 = (post_b(use_half) - ln_prop(use_half)).double().cpu().numpy()
    l2 = (post_b(prop_draws) - ln_prop(prop_draws)).double().cpu().numpy()
    log_s1, log_s2 = np.log(n1 / (n1 + n2)), np.log(n2 / (n1 + n2))

    # Degenerate-overlap guard: if EVERY proposal draw has zero posterior
    # density (l2 all -inf, e.g. a bounded-support posterior with an
    # overdispersed proposal), the bridge estimator has no overlap to work
    # with and the fixed point below would produce -inf + inf = NaN.
    # Surface the failure as a diagnosable -inf with converged=False.
    if not np.any(np.isfinite(l2)):
        return BridgeResult(
            log_evidence=float("-inf"), n_iterations=0, converged=False,
            proposal_mean=mu, proposal_chol=chol,
        )

    # optimal-bridge fixed point on r = log Z (the Meng-Wong iteration in
    # log space): r <- logmean[ exp(l2) / (s1 exp(l2) + s2 exp(r)) ]
    #              - logmean[ 1 / (s1 exp(l1) + s2 exp(r)) ]
    r = float(np.median(l2))    # robust start
    converged = False
    it = 0
    for it in range(1, int(n_iters) + 1):
        num = _logsumexp(l2 - np.logaddexp(log_s1 + l2, log_s2 + r)) \
            - np.log(n2)
        den = _logsumexp(-np.logaddexp(log_s1 + l1, log_s2 + r)) \
            - np.log(n1)
        r_new = float(num - den)
        if abs(r_new - r) < tol * max(1.0, abs(r_new)):
            r = r_new
            converged = True
            break
        r = r_new
    return BridgeResult(
        log_evidence=r, n_iterations=it, converged=converged,
        proposal_mean=mu, proposal_chol=chol,
    )
