"""Bayesian optimisation on the port's GP surrogate.

Counterpart of ``corrla_rs_tpu/ops/bayes_opt.py`` (Jones-Schonlau-Welch EGO /
Snoek 2012):

- acquisitions in closed form for minimisation: expected improvement (EI),
  lower confidence bound (LCB), probability of improvement (PI);
- candidate search: a scrambled-Sobol batch and Gaussian perturbations of
  the incumbent scored in one GP predict, then ``n_grad_steps`` steps of
  projected gradient ascent on the acquisition from the best candidates,
  the gradient by ``torch.autograd.grad`` through the GP posterior (on the
  card, the backward of ``interp.pairwise_dists``, whose forward is the
  kernel-matrix kernel);
- an ask/tell interface, and ``bayes_opt_minimize``, which runs the loop.

Keys split through ``ops.random_svd._split_seed``, the perturbations are
drawn by ``ops.random_svd._draw_sketch`` and the Sobol plan is seeded by
``ops.design._seed_from_key``: the parity tests hand all three the JAX
package's key arithmetic. A GP refit and its BFGS read scalars from the
device every iteration: an ``ask`` is bound by the host.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.ops.design import latin_hypercube, sobol_sample
from corrla_rs_tpu_torch.ops.gp import GpRegressor
from corrla_rs_tpu_torch.utils.device import as_tensor, default_device

__all__ = ["BayesOptResult", "expected_improvement", "lower_confidence_bound",
           "probability_of_improvement", "BayesOpt", "bayes_opt_minimize"]

_SQRT2 = 1.4142135623730951


def _norm_cdf(z):
    return 0.5 * (1.0 + torch.special.erf(z / _SQRT2))


def _norm_pdf(z):
    return torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)


def _mean_var(mean, var):
    mean = as_tensor(mean)
    return mean, as_tensor(var, device=mean.device)


def expected_improvement(mean, var, best, xi: float = 0.01):
    """EI for MINIMIZATION: E[max(best - xi - f, 0)] under N(mean, var)."""
    mean, var = _mean_var(mean, var)
    sd = torch.sqrt(torch.clamp_min(var, 1e-18))
    imp = best - xi - mean
    z = imp / sd
    return imp * _norm_cdf(z) + sd * _norm_pdf(z)


def lower_confidence_bound(mean, var, kappa: float = 2.0):
    """Negated LCB (higher = better) so every acquisition is maximized."""
    mean, var = _mean_var(mean, var)
    return -(mean - kappa * torch.sqrt(torch.clamp_min(var, 1e-18)))


def probability_of_improvement(mean, var, best, xi: float = 0.01):
    mean, var = _mean_var(mean, var)
    sd = torch.sqrt(torch.clamp_min(var, 1e-18))
    return _norm_cdf((best - xi - mean) / sd)


class BayesOptResult(NamedTuple):
    x_best: torch.Tensor     # (d,) best observed input
    y_best: float            # best observed value
    x_hist: torch.Tensor     # (n, d) all evaluated inputs
    y_hist: torch.Tensor     # (n,) all observed values
    n_evals: int


class BayesOpt:
    """ask/tell Bayesian minimisation over a box.

    bounds: (d, 2) [lo, hi] rows. The GP is refit (with hyperparameter MLE)
    on every ``ask``; observations are scored on z-normalised y so the
    acquisition constants (xi, kappa) are scale-free. The GP, the
    candidates and the suggestions live on ``device`` (default
    ``utils.device.default_device()``), in float64.
    """

    def __init__(self, bounds, kernel: str = "rbf",
                 acquisition: str = "ei", xi: float = 0.01,
                 kappa: float = 2.0, noise_var: float = 1e-6,
                 n_candidates: int = 2048, n_grad_steps: int = 25,
                 key=0, device=None):
        self.bounds = np.asarray(bounds, np.float64)
        if self.bounds.ndim != 2 or self.bounds.shape[1] != 2:
            raise ValueError(f"bounds must be (d, 2), got "
                             f"{self.bounds.shape}")
        if acquisition not in ("ei", "lcb", "pi", "variance"):
            raise ValueError(f"unknown acquisition {acquisition!r}")
        self.kernel = kernel
        self.acquisition = acquisition
        self.xi = float(xi)
        self.kappa = float(kappa)
        self.noise_var = float(noise_var)
        self.n_candidates = int(n_candidates)
        self.n_grad_steps = int(n_grad_steps)
        self._key = key
        self._device = (torch.device(device) if device is not None
                        else default_device())
        self._x: list = []
        self._y: list = []

    # -- observations ------------------------------------------------
    def tell(self, x, y):
        x = np.atleast_2d(np.asarray(x, np.float64))
        y = np.atleast_1d(np.asarray(y, np.float64))
        if x.shape[0] != y.shape[0]:
            raise ValueError("x and y must have matching leading dims")
        self._x.extend(list(x))
        self._y.extend(list(y))
        return self

    @property
    def x_observed(self):
        return np.asarray(self._x)

    @property
    def y_observed(self):
        return np.asarray(self._y)

    def _acq_fn(self, gp, best_z):
        if self.acquisition == "ei":
            def acq(xq):
                m, v = gp.predict(xq)
                return expected_improvement(m, v, best_z, self.xi)
        elif self.acquisition == "pi":
            def acq(xq):
                m, v = gp.predict(xq)
                return probability_of_improvement(m, v, best_z, self.xi)
        elif self.acquisition == "variance":
            # pure exploration: maximise the posterior uncertainty
            def acq(xq):
                _m, v = gp.predict(xq)
                return torch.sqrt(torch.clamp_min(v, 1e-18))
        else:
            def acq(xq):
                m, v = gp.predict(xq)
                return lower_confidence_bound(m, v, self.kappa)
        return acq

    def ask(self, n_points: int = 1):
        """Next point(s) to evaluate, (d,) or (n_points, d). Requires >= 2
        observations (use a space-filling initial design, as
        bayes_opt_minimize does)."""
        if len(self._y) < 2:
            raise ValueError("tell() at least 2 observations before ask()")
        dev = self._device
        x = torch.as_tensor(self.x_observed, device=dev)
        y = np.asarray(self._y)
        mu, sd = float(y.mean()), float(y.std() + 1e-12)
        yz = torch.as_tensor((y - mu) / sd, device=dev)
        gp = GpRegressor(kernel=self.kernel, noise_var=self.noise_var)
        # power-of-two padded fit: exact (masked identity rows), and the
        # sizes the GP sees grow in buckets, not one a point
        n = x.shape[0]
        pad_to = max(16, 1 << (int(n - 1).bit_length()))
        gp.fit(x, yz, optimize_hypers=True, pad_to=pad_to)
        i_best = int(np.argmin(y))
        best_z = float((y[i_best] - mu) / sd)
        acq = self._acq_fn(gp, best_z)

        self._key, k_cand = _rsvd._split_seed(self._key, 2, dev)
        cands = sobol_sample(self.bounds, self.n_candidates, key=k_cand,
                             device=dev)
        # exploit around the incumbent too: local Gaussian perturbations
        self._key, k_loc = _rsvd._split_seed(self._key, 2, dev)
        width = torch.as_tensor(self.bounds[:, 1] - self.bounds[:, 0],
                                device=dev)
        noise = _rsvd._draw_sketch(
            k_loc, (max(self.n_candidates // 8, 8), x.shape[1]),
            torch.float64, dev)
        local = x[i_best] + 0.05 * width * noise
        lo = torch.as_tensor(self.bounds[:, 0], device=dev)
        hi = torch.as_tensor(self.bounds[:, 1], device=dev)
        cands = torch.cat([cands, torch.clamp(local, lo, hi)])

        with torch.no_grad():
            scores = acq(cands)
        order = torch.argsort(-scores, stable=True)
        starts = cands[order[: max(4 * n_points, 8)]]

        # projected gradient ascent on the acquisition (sum over the batch:
        # the starts are independent, so the batched gradient is the
        # per-start gradient)
        step = 0.05 * width
        cur = starts
        for _ in range(self.n_grad_steps):
            z = cur.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(torch.sum(acq(z)), z)
            cur = torch.clamp(cur + step * g, lo, hi)
        all_pts = torch.cat([starts, cur.detach()])
        with torch.no_grad():
            all_scores = acq(all_pts)
        best_order = torch.argsort(-all_scores, stable=True).cpu().numpy()
        pts = all_pts.cpu().numpy()
        w = self.bounds[:, 1] - self.bounds[:, 0]
        picked = []
        min_sep = 1e-9
        for idx in best_order:
            pt = pts[idx]
            if any(np.max(np.abs(pt - s) / w) < min_sep for s in picked):
                continue
            picked.append(pt)
            if len(picked) == n_points:
                break
        out = torch.as_tensor(np.stack(picked), device=dev)
        return out[0] if n_points == 1 else out


def bayes_opt_minimize(fn: Callable, bounds, n_init: int = 8,
                       n_iters: int = 30, key=0,
                       **bo_kwargs) -> BayesOptResult:
    """Minimise a black-box ``fn(x) -> float`` over a box.

    fn receives a (d,) float64 tensor on the optimiser's device. n_init:
    LHS initial design size; n_iters: sequential BO evaluations. Extra
    kwargs go to :class:`BayesOpt` (acquisition=, kernel=, device=, ...).
    """
    dev = bo_kwargs.get("device")
    dev = torch.device(dev) if dev is not None else default_device()
    k_init, k_bo = _rsvd._split_seed(key, 2, dev)
    bo = BayesOpt(bounds, key=k_bo, **bo_kwargs)
    x0 = latin_hypercube(bo.bounds, int(n_init), key=k_init, device=dev)
    y0 = [float(fn(p)) for p in x0]
    bo.tell(x0.cpu().numpy(), y0)
    for _ in range(int(n_iters)):
        x_next = bo.ask()
        bo.tell(x_next.cpu().numpy()[None], [float(fn(x_next))])
    y = bo.y_observed
    i = int(np.argmin(y))
    return BayesOptResult(
        x_best=torch.as_tensor(bo.x_observed[i], device=dev),
        y_best=float(y[i]),
        x_hist=torch.as_tensor(bo.x_observed, device=dev),
        y_hist=torch.as_tensor(y, device=dev),
        n_evals=len(y),
    )
