"""Univariate random variables with MLE fitting and KDE.

Counterpart of ``corrla_rs_tpu/ops/univariate_rv.py`` (parity with reference
univariate_rv.rs:157-497: the ``UniRv`` trait, Normal / Beta / Exponential /
KDE and ``build_kde``), as vectorized distributions on tensors:

- pdf/cdf/sample accept an optional ``params`` override exactly like the
  trait methods (univariate_rv.rs:161-163);
- ``nll`` is a vectorized log-pdf sum (the reference parallelizes the
  per-sample loop with Rayon, univariate_rv.rs:165-171);
- ``erf`` and ``gammaln`` are ``torch.special``'s; the regularized incomplete
  beta function, which torch lacks, is ``betainc`` below. The Beta pdf is
  computed in log space, so large shape parameters do not overflow like the
  reference's direct ``gamma()`` products (univariate_rv.rs:304);
- MLE uses exact autodiff gradients (see ``ops.optimize``).

``build_kde``'s train/test splits use a fixed 70/30 permutation split per
iteration instead of the reference's per-sample Bernoulli(0.7) coin
(univariate_rv.rs:470-487), as the JAX package does: a statistically
equivalent bandwidth cross-validation.

Samples that are not tensors go to ``utils.device.default_device()``; fitted
parameters are Python floats.
"""
from __future__ import annotations

import math

import torch

from corrla_rs_tpu_torch.ops.optimize import mlefit_ps_fallback
from corrla_rs_tpu_torch.utils.device import as_tensor, default_device
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["NormalRv", "BetaRv", "ExponentialRv", "KdeRv", "build_kde"]

_SQRT2 = math.sqrt(2.0)
_SQRT2PI = math.sqrt(2.0 * math.pi)
# steps of betainc's continued fraction: it converges in O(sqrt(max(a, b)))
# steps, and the fits bound the shape parameters by 200
_BETACF_STEPS = 200


def betainc(a, b, x) -> torch.Tensor:
    """Regularized incomplete beta function I_x(a, b), elementwise over
    broadcast tensors (the counterpart of ``jax.scipy.special.betainc``).

    The continued fraction of Numerical Recipes' ``betacf`` by the modified
    Lentz method, on x where x < (a + 1) / (a + b + 2) and on 1 - x through
    I_x(a, b) = 1 - I_{1-x}(b, a) elsewhere. A fixed number of steps, so it
    batches; once converged a step multiplies by 1. An ``x`` that is not a
    tensor goes to ``utils.device.default_device()``; ``a`` and ``b`` follow
    ``x``.
    """
    x = as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    a, b, x = torch.broadcast_tensors(a, b, x)
    xc = x.clamp(0.0, 1.0)
    swap = xc > (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(swap, b, a), torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - xc, xc)
    ln_x, ln_1mx = torch.log(xc), torch.log1p(-xc)
    ln_front = (aa * torch.where(swap, ln_1mx, ln_x)
                + bb * torch.where(swap, ln_x, ln_1mx)
                + torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb))
    tiny = 1e-300 if x.dtype == torch.float64 else 1e-30

    def guard(v):
        return torch.where(v.abs() < tiny, torch.full_like(v, tiny), v)

    qab, qap, qam = aa + bb, aa + 1.0, aa - 1.0
    c = torch.ones_like(xx)
    d = 1.0 / guard(1.0 - qab * xx / qap)
    h = d
    for m in range(1, _BETACF_STEPS + 1):
        m2 = 2 * m
        num = m * (bb - m) * xx / ((qam + m2) * (aa + m2))
        d = 1.0 / guard(1.0 + num * d)
        c = guard(1.0 + num / c)
        h = h * d * c
        num = -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))
        d = 1.0 / guard(1.0 + num * d)
        c = guard(1.0 + num / c)
        h = h * d * c
    val = torch.exp(ln_front) * h / aa
    val = torch.where(swap, 1.0 - val, val)
    val = torch.where(x <= 0.0, torch.zeros_like(val), val)
    return torch.where(x >= 1.0, torch.ones_like(val), val)


def _draw_permutations(key, n: int, n_iter: int, device) -> list:
    """``n_iter`` (permutation of n, seed of the fit) pairs: the one place
    ``build_kde`` draws."""
    gen = as_generator(key, device)
    return [(torch.randperm(n, generator=gen, device=device), gen)
            for _ in range(n_iter)]


class _UniRv:
    """Shared NLL + fit plumbing (UniRv default impl, univariate_rv.rs:159-171)."""

    def nll(self, samples, params=None) -> torch.Tensor:
        """Negative log-likelihood of ``samples``. A row-sharded DTensor
        sums its local log-pdfs and psums them: the same value, replicated,
        and its gradient in ``params`` the whole one on every rank."""
        from corrla_rs_tpu_torch.parallel.mesh import _psum_grad, \
            _to_local, rows_of_dtensor

        rows = rows_of_dtensor(samples)
        if rows is not None:
            x_l, _shape, mesh, axis = rows
            if isinstance(params, torch.Tensor):
                params = _to_local(params, mesh, axis)
            return -_psum_grad(torch.sum(torch.log(self.pdf(x_l, params))),
                               mesh, axis)
        x = as_tensor(samples)
        return -torch.sum(torch.log(self.pdf(x, params)))


def _abs(v):
    return v.abs() if isinstance(v, torch.Tensor) else abs(v)


def _on(x: torch.Tensor, p_init) -> torch.Tensor:
    """Start parameters in float64 on the samples' device."""
    return torch.tensor(p_init, dtype=torch.float64, device=x.device)

class NormalRv(_UniRv):
    """Normal distribution. univariate_rv.rs:175-239."""

    def __init__(self, mu: float, std: float):
        self.mu = mu
        self.std = std

    def _params(self, params):
        if params is None:
            return self.mu, self.std
        return params[0], params[1]

    def pdf(self, x, params=None):
        mu, std = self._params(params)
        std = _abs(std)  # parity: par[1].abs() (univariate_rv.rs:214)
        z = (as_tensor(x) - mu) / std
        return torch.exp(-0.5 * z * z) / (std * _SQRT2PI)

    def cdf(self, x, params=None):
        mu, std = self._params(params)
        return 0.5 * (1.0 + torch.erf((as_tensor(x) - mu) / (std * _SQRT2)))

    def sample(self, n_samples: int, params=None, key=0):
        mu, std = self._params(params)
        dev = default_device()
        z = torch.randn((n_samples,), generator=as_generator(key, dev),
                        dtype=torch.float64, device=dev)
        return mu + std * z

    def mlfit(self, samples, method: int | None = 2, key=0):
        """MLE fit; init/bounds parity with univariate_rv.rs:191-207."""
        x = as_tensor(samples)
        cost = lambda p: self.nll(x, p)
        p = mlefit_ps_fallback(
            cost, _on(x, [10.0, 10.0]), [[-1000.0, 1e-12], [1000.0, 1000.0]],
            method if method is not None else 2, key,
        )
        self.mu, self.std = float(p[0]), float(abs(p[1]))
        return self


class BetaRv(_UniRv):
    """Beta distribution on [lower_b, upper_b]. univariate_rv.rs:243-329."""

    def __init__(self, alpha: float, beta: float, lower_b: float = 0.0,
                 upper_b: float = 1.0):
        self.alpha = alpha
        self.beta = beta
        self.lower_b = lower_b
        self.upper_b = upper_b

    def _params(self, params):
        if params is None:
            return self.alpha, self.beta
        return params[0], params[1]

    def _scale(self, x):
        return (as_tensor(x) - self.lower_b) / (self.upper_b - self.lower_b)

    def pdf(self, x, params=None):
        a, b = self._params(params)
        xs = self._scale(x)
        a = torch.as_tensor(a, dtype=xs.dtype, device=xs.device)
        b = torch.as_tensor(b, dtype=xs.dtype, device=xs.device)
        # log-space Beta pdf (the reference's direct gamma() products
        # overflow past a+b ~ 170, univariate_rv.rs:297-306)
        ln_b = torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)
        ln_pdf = (a - 1.0) * torch.log(xs) + (b - 1.0) * torch.log1p(-xs) - ln_b
        return torch.exp(ln_pdf)

    def cdf(self, x, params=None):
        a, b = self._params(params)
        return betainc(a, b, self._scale(x))

    def sample(self, n_samples: int, params=None, key=0):
        a, b = self._params(params)
        dev = default_device()
        gen = as_generator(key, dev)
        # Beta(a, b) = Ga / (Ga + Gb); the public Gamma sampler takes no
        # generator, only the private torch._standard_gamma does
        conc = torch.tensor([float(a), float(b)], dtype=torch.float64,
                            device=dev).expand(n_samples, 2).contiguous()
        g = torch._standard_gamma(conc, generator=gen)
        z = g[:, 0] / (g[:, 0] + g[:, 1])
        return z * (self.upper_b - self.lower_b) + self.lower_b

    def mlfit(self, samples, method: int | None = None, key=0):
        """method=None: closed-form method of moments
        (univariate_rv.rs:279-292); otherwise MLE with init [1, 1] and
        bounds [1e-4, 200] (univariate_rv.rs:265-277)."""
        x = as_tensor(samples)
        if method is None:
            y_mu = float(torch.mean(x))
            y_var = float(torch.var(x, correction=1))
            a, c = self.lower_b, self.upper_b
            common = a * c - a * y_mu - c * y_mu + y_mu**2 + y_var
            self.alpha = (a - y_mu) * common / (y_var * (c - a))
            self.beta = -(c - y_mu) * common / (y_var * (c - a))
            return self
        cost = lambda p: self.nll(x, p)
        p = mlefit_ps_fallback(
            cost, _on(x, [1.0, 1.0]), [[1e-4, 1e-4], [200.0, 200.0]], method,
            key,
        )
        self.alpha, self.beta = float(p[0]), float(p[1])
        return self


class ExponentialRv(_UniRv):
    """Exponential distribution. univariate_rv.rs:332-382."""

    def __init__(self, lam: float):
        self.lam = lam

    def _params(self, params):
        return self.lam if params is None else params[0]

    def pdf(self, x, params=None):
        lam = self._params(params)
        return lam * torch.exp(-lam * as_tensor(x))

    def cdf(self, x, params=None):
        lam = self._params(params)
        return 1.0 - torch.exp(-lam * as_tensor(x))

    def sample(self, n_samples: int, params=None, key=0):
        lam = self._params(params)
        dev = default_device()
        e = torch.empty((n_samples,), dtype=torch.float64, device=dev)
        e.exponential_(generator=as_generator(key, dev))
        return e / lam

    def mlfit(self, samples, method: int | None = 2, key=0):
        """Init/bounds parity with univariate_rv.rs:344-355."""
        x = as_tensor(samples)
        cost = lambda p: self.nll(x, p)
        p = mlefit_ps_fallback(
            cost, _on(x, [1.0]), [[1e-12], [100.0]],
            method if method is not None else 2, key,
        )
        self.lam = float(p[0])
        return self


class KdeRv(_UniRv):
    """Gaussian-kernel KDE (the kernel is a fixed standard normal, as in
    the reference, univariate_rv.rs:385-460)."""

    def __init__(self, bandwidth: float, samples):
        self.bandwidth = float(bandwidth)
        self.supports = as_tensor(samples)
        n = self.supports.shape[0]
        self.weights = torch.ones((n,), dtype=self.supports.dtype,
                                  device=self.supports.device) / n

    def _bw(self, params):
        return self.bandwidth if params is None else params[0]

    def _query(self, x):
        return torch.atleast_1d(as_tensor(x, device=self.supports.device))

    def pdf(self, x, params=None):
        bw = _abs(self._bw(params))
        x = self._query(x)
        z = (x[:, None] - self.supports[None, :]) / bw
        k = torch.exp(-0.5 * z * z) / (bw * _SQRT2PI)
        out = torch.sum(self.weights[None, :] * k, dim=1)
        return out if out.shape[0] > 1 else out[0]

    def cdf(self, x, params=None):
        bw = self._bw(params)
        x = self._query(x)
        z = (x[:, None] - self.supports[None, :]) / (bw * _SQRT2)
        c = 0.5 * (1.0 + torch.erf(z))
        out = torch.sum(self.weights[None, :] * c, dim=1)
        return out if out.shape[0] > 1 else out[0]

    def sample(self, n_samples: int, params=None, key=0):
        """Ancestral sampling: random kernel + normal draw
        (univariate_rv.rs:445-459)."""
        bw = self._bw(params)
        dev = self.supports.device
        gen = as_generator(key, dev)
        idx = torch.randint(0, self.supports.shape[0], (n_samples,),
                            generator=gen, device=dev)
        z = torch.randn((n_samples,), generator=gen, dtype=torch.float64,
                        device=dev)
        return self.supports[idx] + bw * z

    def est_bandwidth(self, test_samples, method: int | None = 2, key=0):
        """MLE bandwidth on held-out samples; init/bounds parity with
        univariate_rv.rs:406-420."""
        x = as_tensor(test_samples, device=self.supports.device)
        cost = lambda p: self.nll(x, p)
        p = mlefit_ps_fallback(
            cost, _on(x, [self.bandwidth]), [[1e-9], [1000.0]],
            method if method is not None else 2, key,
        )
        return float(p[0])


def build_kde(init_bandwidth: float, samples, n_iter: int = 10,
              method: int = 2, key=0) -> KdeRv:
    """KDE with cross-validated bandwidth: median over n_iter random 70/30
    train/test splits. Parity with univariate_rv.rs:464-497 (fixed-ratio
    permutation splits instead of per-sample coins)."""
    x = as_tensor(samples)
    n = x.shape[0]
    n_train = max(int(0.7 * n), 2)
    bws = []
    for perm, k_fit in _draw_permutations(key, n, n_iter, x.device):
        train = x[perm[:n_train]]
        test = x[perm[n_train:]]
        bw = KdeRv(init_bandwidth, train).est_bandwidth(test, method, k_fit)
        bws.append(bw)
    bws.sort()
    return KdeRv(bws[len(bws) // 2], x)
