"""Gaussian copula with empirical marginals (extension).

Counterpart of ``corrla_rs_tpu/ops/copula.py``:

- ``GaussianCopula.fit``: each marginal to normal scores through its
  empirical ranks (argsort, then the ranks scattered back, on the device),
  the latent correlation matrix of the scores;
- ``sample``: correlated normals (Cholesky), pushed through the normal CDF
  and the stored empirical marginals by interpolation.

``BivariateCopula`` is the one-pair surface of ``ops.vine``'s families.
Normal draws go through ``ops.random_svd._draw_sketch``, uniform ones
through ``ops.vine._draw_uniform``.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.ops import vine as _v
from corrla_rs_tpu_torch.utils.checkpoint import register_model_class
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["GaussianCopula", "BivariateCopula"]


@register_model_class
class GaussianCopula:
    """Dependence model: Gaussian copula over empirical marginals."""

    def fit(self, samples, device=None):
        """Fit to (n, d) samples; numpy goes to ``device`` (default
        ``utils.device.default_device()``)."""
        x = as_tensor(samples, device=device)
        n, d = x.shape
        # normal scores from mid-ranks (Hazen plotting positions)
        z = _v._norm_ppf(_v._pseudo_obs(x))
        zc = z - z.mean(dim=0, keepdim=True)
        corr = zc.mT @ zc
        dd = torch.sqrt(torch.diagonal(corr))
        self.corr = corr / (dd[:, None] * dd[None, :])
        # sorted marginals for quantile inversion
        self._marginals = torch.sort(x, dim=0).values
        self.n, self.d = n, d
        return self

    def sample(self, n_samples: int, key=0) -> torch.Tensor:
        chol = torch.linalg.cholesky(
            self.corr + 1e-6 * torch.eye(self.d, dtype=self.corr.dtype,
                                         device=self.corr.device)
        )
        z = _rsvd._draw_sketch(key, (int(n_samples), self.d),
                               self.corr.dtype, self.corr.device)
        u = _v._norm_cdf(z @ chol.mT)
        return _v._marginal_sample(u, self.n, self._marginals)


@register_model_class
class BivariateCopula:
    """Bivariate copula with selectable family (extension).

    The families of ``ops.vine`` (which are also the pair-copulas of
    ``CVineCopula``) as a standalone surface: tau-inversion fits,
    h-function sampling, log-densities.

    family: one of ``ops.vine.FAMILIES`` or "auto" (AIC selection, the
    independence copula as the baseline). Marginals are empirical, like
    ``GaussianCopula``.
    """

    def __init__(self, family: str = "auto", refine: bool = False):
        if family != "auto" and family not in _v.FAMILIES:
            raise ValueError(
                f"family must be 'auto' or one of {_v.FAMILIES}, got "
                f"{family!r}"
            )
        self.family = family
        # refine=True: golden-section MLE of theta seeded by tau inversion
        self.refine = bool(refine)

    def fit(self, samples, device=None):
        """samples: (n, 2) (numpy goes to ``device``, default
        ``utils.device.default_device()``). Rank-transform to uniforms, fit
        theta by Kendall-tau inversion (family='auto': best AIC across
        families); ``refine=True`` then maximizes the log-likelihood over
        theta."""
        x = as_tensor(samples, device=device)
        n, d = x.shape
        if d != 2:
            raise ValueError(
                f"BivariateCopula needs (n, 2) samples, got {tuple(x.shape)}")
        u = _v._pseudo_obs(x)
        if self.family == "auto":
            fam, theta, tau = _v._fit_pair(u[:, 0], u[:, 1],
                                           refine=self.refine)
        else:
            tau = float(_v.kendall_tau(u[:, 0], u[:, 1]))
            fam = self.family
            if not _v._family_admissible(fam, tau):
                hint = (
                    "a 90/270 rotation (e.g. 'clayton90'), 'frank', "
                    "'gaussian' or 'auto'" if tau <= 0.0 else
                    "the unrotated family or a 180 rotation, or 'auto'"
                )
                raise ValueError(
                    f"{fam} copula cannot represent dependence of this "
                    f"sign (tau={tau:.3f}); use {hint}"
                )
            theta = _v._theta_from_tau(fam, tau)
            if self.refine and fam != "independent":
                scorer = _v._PairScorer(u[:, 0], u[:, 1], [fam])
                theta = _v._mle_refine(scorer, [theta])[0][0]
        self.fitted_family, self.theta, self.tau = fam, theta, tau
        self._marginals = torch.sort(x, dim=0).values
        self.n = n
        return self

    def logpdf_uniform(self, u, v):
        """Copula log-density at uniform coordinates (u, v); numpy goes to
        the fit's device."""
        dev = self._marginals.device
        u = as_tensor(u, device=dev)
        v = as_tensor(v, device=dev)
        return _v._LOGPDF[self.fitted_family](_v._clip_u(u), _v._clip_u(v),
                                             self.theta)

    def sample_uniform(self, n_samples: int, key=0) -> torch.Tensor:
        """(n, 2) uniform-marginal draws via the inverse h-function."""
        w = _v._draw_uniform(key, (int(n_samples), 2), torch.float64,
                             self._marginals.device)
        v = w[:, 0]
        u = _v._HINV[self.fitted_family](w[:, 1], v, self.theta)
        return torch.stack([_v._clip_u(u), v], dim=1)

    def sample(self, n_samples: int, key=0) -> torch.Tensor:
        """(n, 2) draws with the fitted empirical marginals."""
        return _v._marginal_sample(self.sample_uniform(n_samples, key=key),
                                   self.n, self._marginals)
