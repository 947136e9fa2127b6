"""Shapley effects: variance attribution for dependent inputs.

Counterpart of ``corrla_rs_tpu/ops/shapley.py`` (Owen 2014; Song, Nelson &
Staum 2016): the Shapley value of the game val(S) = Var(E[Y | X_S]) /
Var(Y), which always sums to 1 and splits shared variance between
correlated inputs, by exact-weight enumeration of the 2^d subsets.

- ``shapley_effects``: each val(S) by nested conditional Monte Carlo under
  x ~ N(mean, cov). The standard normals come from this module's seam,
  ``_draw_shapley`` (outer (n_outer, d), inner (n_outer, n_inner, d)), and
  the same ones serve every subset (common random numbers). The outer draws
  and each subset's Gaussian conditional draws are built on the device
  (the JAX package builds them in host numpy), from the small conditional
  factors solved on the host, and the model sees one device batch a
  subset.
- ``shapley_effects_linear``: the closed form for a linear model (host
  numpy, as in the JAX package).
- ``shapley_effects_quadrature``: every subset value from one tensor
  Gauss grid for independent inputs; the model is called once on the grid
  on the device, the contractions are host numpy.
"""
from __future__ import annotations

import itertools
from math import factorial
from typing import Callable

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import _host_f64, as_tensor, \
    default_device
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["shapley_effects", "shapley_effects_linear",
           "shapley_effects_quadrature"]


def _draw_shapley(key, n_outer: int, n_inner: int, d: int, device):
    """(z_out (n_outer, d), z_in (n_outer, n_inner, d)) float64 standard
    normals on ``device``: every draw one Shapley estimate needs."""
    gen = as_generator(key, device)
    z_out = torch.randn((n_outer, d), generator=gen, dtype=torch.float64,
                        device=device)
    z_in = torch.randn((n_outer, n_inner, d), generator=gen,
                       dtype=torch.float64, device=device)
    return z_out, z_in


def _subset_val_linear(beta, cov, s_idx):
    """Exact val(S) = Var(E[Y|X_S]) for linear y = beta^T x, Gaussian x:
    E[Y|X_S] is linear in x_S with coefficients
    gamma = beta_S + Sigma_SS^-1 Sigma_S,Sc beta_Sc."""
    if len(s_idx) == 0:
        return 0.0
    d = beta.shape[0]
    sc = [j for j in range(d) if j not in s_idx]
    s = np.asarray(s_idx)
    css = cov[np.ix_(s, s)]
    if sc:
        csc = cov[np.ix_(s, np.asarray(sc))]
        gamma = beta[s] + np.linalg.solve(css, csc @ beta[np.asarray(sc)])
    else:
        gamma = beta[s]
    return float(gamma @ css @ gamma)


def _combine_shapley(vals: dict, d: int) -> np.ndarray:
    """Exact Shapley combination of subset values: sum over subsets of
    |S|!(d-|S|-1)!/d! increments, normalized by val(full set)."""
    var_y = max(vals[tuple(range(d))], 1e-300)
    sh = np.zeros(d)
    fact_d = factorial(d)
    for s, v in vals.items():
        for i in range(d):
            if i in s:
                continue
            s_with = tuple(sorted(s + (i,)))
            w = factorial(len(s)) * factorial(d - len(s) - 1) / fact_d
            sh[i] += w * (vals[s_with] - v)
    return sh / var_y


def shapley_effects_linear(beta, cov) -> np.ndarray:
    """Closed-form Shapley effects of y = beta^T x, x ~ N(mu, cov):
    (d,) nonnegative, summing to 1."""
    beta = np.asarray(beta, np.float64)
    cov = np.asarray(cov, np.float64)
    d = beta.shape[0]
    vals = {}
    for r in range(d + 1):
        for s in itertools.combinations(range(d), r):
            vals[s] = _subset_val_linear(beta, cov, list(s))
    return _combine_shapley(vals, d)


def _conditional_factors(cov, s_idx, d):
    """Gaussian conditional of the complement given x_S: returns
    (sc, reg (|sc|, |s|), chol (|sc|, |sc|)) with
    x_sc | x_s ~ N(mu_sc + reg (x_s - mu_s), chol chol^T)."""
    sc = [j for j in range(d) if j not in s_idx]
    s = np.asarray(s_idx, int)
    scn = np.asarray(sc, int)
    css = cov[np.ix_(s, s)]
    csc_s = cov[np.ix_(scn, s)]
    reg = np.linalg.solve(css, csc_s.T).T
    cc = cov[np.ix_(scn, scn)] - reg @ csc_s.T
    cc = 0.5 * (cc + cc.T) + 1e-12 * np.eye(len(sc))
    return scn, reg, np.linalg.cholesky(cc)


def _conditional_factors(cov, s_idx, d):
    """Gaussian conditional of the complement given x_S: returns
    (sc, reg (|sc|, |s|), chol (|sc|, |sc|)) with
    x_sc | x_s ~ N(mu_sc + reg (x_s - mu_s), chol chol^T)."""
    sc = [j for j in range(d) if j not in s_idx]
    s = np.asarray(s_idx, int)
    scn = np.asarray(sc, int)
    css = cov[np.ix_(s, s)]
    csc_s = cov[np.ix_(scn, s)]
    reg = np.linalg.solve(css, csc_s.T).T
    cc = cov[np.ix_(scn, scn)] - reg @ csc_s.T
    cc = 0.5 * (cc + cc.T) + 1e-12 * np.eye(len(sc))
    return scn, reg, np.linalg.cholesky(cc)


def shapley_effects(model: Callable, mean, cov, n_outer: int = 128,
                    n_inner: int = 64, key=0, batch_model: bool = True,
                    device=None) -> torch.Tensor:
    """Monte Carlo Shapley effects of ``model`` under x ~ N(mean, cov).

    model: (n, d) -> (n,) batched callable on float64 tensors on
    ``device`` (default ``utils.device.default_device()``; vmap a scalar
    model yourself otherwise). Cost: 2^d subset evaluations of an
    (n_outer * n_inner)-point batch, exact Shapley weights; d <= ~15.
    Returns a (d,) float64 tensor on ``device``.
    """
    mean = np.asarray(mean, np.float64)
    cov = np.asarray(cov, np.float64)
    d = mean.shape[0]
    if d > 15:
        raise ValueError(f"subset enumeration is 2^d; d={d} is too large")
    dev = torch.device(device) if device is not None else default_device()

    def const(v):
        return torch.as_tensor(v, dtype=torch.float64, device=dev)

    # shared outer draws of the full vector (subset marginals come from
    # the joint by projection: common random numbers across subsets)
    z_out, z_in = _draw_shapley(key, int(n_outer), int(n_inner), d, dev)
    chol_full = np.linalg.cholesky(cov + 1e-12 * np.eye(d))
    mean_t = const(mean)
    x_out = mean_t + z_out @ const(chol_full).mT

    def evaluate(x):
        return as_tensor(model(x), device=dev).reshape(-1).to(torch.float64)

    def val_of(s_idx):
        if len(s_idx) == 0:
            return 0.0
        if len(s_idx) == d:
            return float(evaluate(x_out).var(correction=0))
        scn, reg, chol_c = _conditional_factors(cov, s_idx, d)
        s = torch.as_tensor(np.asarray(s_idx, int), device=dev)
        sc = torch.as_tensor(scn, device=dev)
        xs = x_out[:, s]                                  # (no, |s|)
        mu_c = mean_t[sc] + (xs - mean_t[s]) @ const(reg).mT
        draws = (mu_c[:, None, :]
                 + z_in[:, :, : len(scn)] @ const(chol_c).mT)
        x_full = torch.empty((int(n_outer), int(n_inner), d),
                             dtype=torch.float64, device=dev)
        x_full[:, :, s] = xs[:, None, :]
        x_full[:, :, sc] = draws
        yy = evaluate(x_full.reshape(-1, d)).reshape(int(n_outer),
                                                     int(n_inner))
        cond_mean = yy.mean(dim=1)
        # the variance of an n_inner-sample mean is inflated by
        # E[Var(Y|X_S)]/n_inner: subtract the standard correction
        # (Song-Nelson-Staum), no extra model evaluations
        within = yy.var(dim=1, correction=1).mean()
        return float((cond_mean.var(correction=0)
                      - within / n_inner).clamp_min(0.0))

    vals = {}
    for r in range(d + 1):
        for s in itertools.combinations(range(d), r):
            vals[s] = val_of(list(s))
    return torch.as_tensor(_combine_shapley(vals, d), device=dev)


def shapley_effects_quadrature(model: Callable, mean=None, std=None,
                               n_quad: int = 16, rules=None,
                               device=None) -> dict:
    """Quadrature-EXACT Shapley effects + Sobol indices for INDEPENDENT
    Gaussian inputs, x_i ~ N(mean_i, std_i^2), d <= ~6.

    The MC estimator above pays outer-loop variance on every subset —
    on skewed QoIs (e.g. exp-of-Gaussian responses) its scatter at
    n_outer=512 is about +-0.15 a share. For independent
    Gaussians every conditional expectation E[Y | X_S] is a plain
    marginalization, so a tensorized Gauss-Hermite grid gives ALL 2^d
    subset variances val(S) = Var(E[Y|X_S]) from ONE batched model
    evaluation of n_quad^d points — no sampling noise at all. Exactness: the
    subset variances integrate the SQUARE of the conditional mean, so a
    degree-p polynomial model needs the rule exact to degree 2p —
    n_quad >= p + 1 per dim (NOT the (p+1)/2 a plain Gauss rule would
    suggest); smooth integrands converge spectrally in n_quad.

    Since the same grid carries the full ANOVA information, the first-
    order and total Sobol indices come for free, making Owen's sandwich
    S1_i <= Shapley_i <= ST_i checkable as a mathematical identity
    instead of an MC coin flip.

    model: (n, d) -> (n,) batched callable (same contract as
    ``shapley_effects``), called once on the whole grid as a float64
    tensor on ``device`` (default ``utils.device.default_device()``); the
    tensor contractions are O(n_quad^d) host f64, negligible.

    rules: optional list of d (nodes_i, weights_i) pairs in PHYSICAL
    space — any independent product measure with a 1-d quadrature rule
    per input (Gauss-Legendre for uniform/truncated inputs, GH for
    Gaussian, …). When given, ``mean``/``std`` are ignored and per-dim
    node counts may differ.

    Returns {"shapley", "s1", "st" (each (d,) np.float64), "var",
    "mean" (floats)}. For DEPENDENT (non-diagonal) covariances use
    ``shapley_effects`` — conditioning is no longer marginalization and
    the grid trick does not apply.
    """
    if rules is not None:
        grids = [np.asarray(n, np.float64).reshape(-1) for n, _ in rules]
        wts = [np.asarray(w, np.float64).reshape(-1) for _, w in rules]
        d = len(rules)
        for i, (g, w) in enumerate(zip(grids, wts)):
            if g.shape != w.shape:
                raise ValueError(f"rules[{i}]: {g.shape[0]} nodes vs "
                                 f"{w.shape[0]} weights")
        wts = [w / w.sum() for w in wts]
    else:
        mean = np.asarray(mean, np.float64).reshape(-1)
        std = np.asarray(std, np.float64)
        d = mean.shape[0]
        if std.ndim == 2:
            off = std - np.diag(np.diag(std))
            if np.any(np.abs(off)
                      > 1e-12 * max(np.max(np.abs(std)), 1e-300)):
                raise ValueError(
                    "shapley_effects_quadrature needs INDEPENDENT "
                    "inputs (diagonal covariance); use shapley_effects "
                    "for dependent inputs")
            std = np.sqrt(np.diag(std))
        std = std.reshape(-1)
        if std.shape[0] != d:
            raise ValueError(
                f"std has {std.shape[0]} entries, mean has {d}")
        # probabilists' Hermite rule: weight e^{-z^2/2} => N(0,1) nodes
        z, w = np.polynomial.hermite_e.hermegauss(int(n_quad))
        w = w / w.sum()
        grids = [mean[i] + std[i] * z for i in range(d)]
        wts = [w] * d
    n_pts = int(np.prod([g.shape[0] for g in grids]))
    if n_pts > 4_000_000:
        raise ValueError(
            f"the tensor grid has {n_pts} points, which is too large; "
            "lower n_quad or use the MC estimator")
    x_grid = np.stack(
        np.meshgrid(*grids, indexing="ij"), axis=-1).reshape(-1, d)
    y = _host_f64(model(as_tensor(x_grid, device=device))).reshape(-1)
    vals_nd = y.reshape(tuple(g.shape[0] for g in grids))

    def marginalize(keep):
        arr = vals_nd
        for dim in sorted(set(range(d)) - set(keep), reverse=True):
            arr = np.tensordot(arr, wts[dim], axes=([dim], [0]))
        return arr

    mu = float(marginalize(()))

    def val_of(keep):
        if not keep:
            return 0.0
        arr = marginalize(keep)
        ww = np.ones_like(arr)
        for pos, dim in enumerate(keep):
            shape = [1] * len(keep)
            shape[pos] = grids[dim].shape[0]
            ww = ww * wts[dim].reshape(shape)
        return float(np.sum(ww * (arr - mu) ** 2))

    vals = {}
    for r in range(d + 1):
        for s in itertools.combinations(range(d), r):
            vals[s] = val_of(s)
    var_y = max(vals[tuple(range(d))], 1e-300)
    s1 = np.array([vals[(i,)] for i in range(d)]) / var_y
    st = np.array([
        var_y - vals[tuple(j for j in range(d) if j != i)]
        for i in range(d)
    ]) / var_y
    return {
        "shapley": _combine_shapley(vals, d),
        "s1": s1,
        "st": st,
        "var": var_y,
        "mean": mu,
    }
