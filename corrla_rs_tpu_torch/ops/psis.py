"""Pareto-smoothed importance sampling (PSIS).

Counterpart of ``corrla_rs_tpu/ops/psis.py``. Importance sampling reweights
draws from a proposal onto a target (model updates without re-sampling,
leave-one-out cross-validation of Bayesian fits, evidence ratios), but raw
weights are unreliable when the proposal's tails are too light: a few huge
weights dominate silently. PSIS (Vehtari, Simpson, Gelman, Yao & Gabry, JMLR
2024) fits a generalized Pareto distribution (GPD) to the largest weights,
replaces them by their expected order statistics under the fit, and returns
the shape estimate k-hat as a RELIABILITY DIAGNOSTIC:

    k-hat <= 0.5   : sound (finite variance),
    0.5 < k < 0.7  : usable, slower convergence,
    k-hat >= 0.7   : do not trust the estimate (Vehtari's threshold);
    k-hat = +inf   : too few weights to assess at all (n_tail < 5).

The GPD fit is Zhang & Stephens (2009)'s quasi-Bayes profile estimator (the
one PSIS prescribes): a closed-form profile likelihood over a fixed grid of
theta values, with no iterative optimizer. As in the JAX package the fit is
numpy on the host in f64, on the tail alone (at most 3 sqrt(n) exceedances);
the weight vector itself stays on its device, where the tail is selected,
the smoothed tail scattered back and the weights normalized.
``importance_resample`` draws its indices through the one seam
``_draw_categorical``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["PsisResult", "psis", "importance_resample"]


class PsisResult(NamedTuple):
    log_weights: torch.Tensor  # (n,) smoothed, self-normalized log weights
    k_hat: float               # GPD shape diagnostic
    n_tail: int                # number of smoothed tail weights
    ess: float                 # effective sample size of the weights


def _draw_categorical(key, log_weights: torch.Tensor, n_draws: int):
    """``n_draws`` indices with probabilities exp(log_weights) (normalized),
    on the weights' device: the one place this module draws. ``key`` is an
    int seed or a ``torch.Generator``."""
    gen = as_generator(key, log_weights.device)
    return torch.multinomial(torch.exp(log_weights), n_draws,
                             replacement=True, generator=gen)


def _gpd_fit(x: np.ndarray):
    """Zhang-Stephens (2009) GPD fit to exceedances x > 0: returns
    (k, sigma) for the parameterization cdf = 1 - (1 + k x / sigma)^(-1/k)
    (k here is the Pareto tail index: k > 0 = heavy tail)."""
    x = np.sort(x)
    n = x.shape[0]
    m = 30 + int(np.sqrt(n))
    prior_b = 3.0
    quart = x[int(np.floor(n / 4.0 + 0.5)) - 1]
    theta = (1.0 / x[-1]
             + (1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5)))
             / (prior_b * max(quart, 1e-300)))
    # profile log-likelihood at each theta
    k_prof = -np.mean(np.log1p(-theta[:, None] * x[None, :]), axis=1)
    ll = n * (np.log(theta / k_prof) + k_prof - 1.0)
    ll -= ll.max()
    w = np.exp(ll)
    w /= w.sum()
    theta_hat = float(np.dot(w, theta))
    # mean log1p(-theta x) = -k_ZS = the Pareto tail index xi directly
    # (Zhang-Stephens' k is the NEGATIVE of the usual xi)
    k = float(np.mean(np.log1p(-theta_hat * x)))
    sigma = float(-k / theta_hat) if theta_hat != 0 else float(np.std(x))
    # Vehtari 2024 regularization toward 0.5 for small tails
    k = k * n / (n + 10.0) + 0.5 * 10.0 / (n + 10.0)
    return k, sigma


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Bring a small f64 tensor to the host: the one place ``psis`` copies
    off the weights' device, and only the tail ever goes through it."""
    return t.cpu().numpy()


def psis(log_weights) -> PsisResult:
    """Smooth raw importance log-weights; returns self-normalized smoothed
    log-weights (on the raw weights' device, or the default device for a
    numpy input), k-hat, the tail size and the weight ESS.

    The n weights stay on their device: the shift, the selection of the
    tail (``torch.topk``), the normalization and the ESS run there in f64.
    Only the n_tail = min(n / 5, 3 sqrt(n)) exceedances and the cutoff come
    to the host for the Pareto fit, and the smoothed tail is scattered back.
    """
    lw = as_tensor(log_weights).detach().double().ravel()
    n = lw.shape[0]
    if n < 5:
        raise ValueError(f"need >= 5 weights, got {n}")
    lw = lw - lw.max()
    # tail size per the paper: min(n/5, 3 sqrt(n))
    n_tail = int(min(np.ceil(0.2 * n), np.ceil(3.0 * np.sqrt(n))))
    if n_tail >= 5:
        # the n_tail largest and the cutoff below them, ascending
        top, top_idx = torch.topk(lw, n_tail + 1)
        tail_idx = top_idx[:-1].flip(0)
        host = _to_host(top.flip(0))
        cutoff, tail = host[0], host[1:]
        exceed = np.exp(tail) - np.exp(cutoff)
        k_hat, sigma = _gpd_fit(exceed + 1e-300)
        if np.isfinite(k_hat):
            # expected order statistics of the fitted GPD
            p = (np.arange(1, n_tail + 1) - 0.5) / n_tail
            if abs(k_hat) < 1e-12:
                q = -sigma * np.log1p(-p)
            else:
                q = sigma / k_hat * ((1.0 - p) ** (-k_hat) - 1.0)
            smoothed = np.log(q + np.exp(cutoff))
            # tail_idx is in rank order, so the order within the tail is
            # preserved; cap at the max
            lw[tail_idx] = torch.as_tensor(np.minimum(smoothed, 0.0),
                                           device=lw.device)
    else:
        # too few tail points to fit the GPD: the diagnostic CANNOT certify
        # the weights, so fail safe (inf reads as 'do not trust' under the
        # documented k_hat thresholds), never as sound
        k_hat = float("inf")
    lw = lw - lw.max()
    w = torch.exp(lw)
    w_sum = w.sum()
    ess = w_sum ** 2 / torch.sum(w ** 2)
    return PsisResult(
        log_weights=lw - torch.log(w_sum),
        k_hat=float(k_hat),
        n_tail=int(n_tail if n_tail >= 5 else 0),
        ess=float(ess),
    )


def importance_resample(samples, log_weights, n_draws: int, key=0):
    """Sampling-importance-resampling with PSIS-smoothed weights:
    (n_draws, d) approximate target draws and the PsisResult (CHECK
    k_hat < 0.7 before trusting them). ``key`` is an int seed or a
    ``torch.Generator`` on the samples' device."""
    samples = as_tensor(samples)
    res = psis(log_weights)
    idx = _draw_categorical(key, res.log_weights.to(samples.device),
                            int(n_draws))
    return samples[idx], res
