"""Rank selection for randomized factorizations.

Counterpart of ``corrla_rs_tpu/ops/rank_select.py`` (beyond the reference,
whose random_svd takes the target rank as a user guess). Two standard,
complementary answers to "what rank does this data support?":

- :func:`svht_threshold` / :func:`select_rank`: the Gavish-Donoho (2014)
  optimal hard threshold for singular values, asymptotically minimax
  truncation under additive white noise, for known or unknown noise level.
  Use on the spectrum you already computed. Host arithmetic on a handful of
  numbers; a tensor of singular values is read back once.
- :func:`range_error_estimate`: the Halko-Martinsson-Tropp (2011, sec. 4.3)
  a-posteriori bound on ||(I - Q Q^T) A||_2 from a handful of Gaussian
  probes: certifies whether a computed basis Q captures A to tolerance
  WITHOUT a dense SVD. :func:`adaptive_random_svd` wraps it in a
  rank-doubling loop on the host, which reads the estimate once a round.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["svht_threshold", "select_rank", "range_error_estimate",
           "adaptive_random_svd"]


def _host_f64(sigma) -> np.ndarray:
    if isinstance(sigma, torch.Tensor):
        sigma = sigma.detach().cpu().numpy()
    return np.asarray(sigma, np.float64).reshape(-1)


def _omega_approx(beta: float) -> float:
    """Gavish-Donoho eq. (5): the unknown-noise coefficient omega(beta)
    (median-based), via their cubic approximation (<0.02% error)."""
    return 0.56 * beta**3 - 0.95 * beta**2 + 1.82 * beta + 1.43


def _lambda_star(beta: float) -> float:
    """Gavish-Donoho eq. (11): known-noise coefficient lambda*(beta)."""
    return float(np.sqrt(
        2.0 * (beta + 1.0)
        + 8.0 * beta / (beta + 1.0 + np.sqrt(beta**2 + 14.0 * beta + 1.0))
    ))


def svht_threshold(shape, noise: float | None = None,
                   sigma=None) -> float:
    """Optimal hard threshold tau for singular values of an (m, n)
    matrix = low-rank + white noise (Gavish & Donoho 2014).

    shape: (m, n) of the data matrix; noise: the noise standard
    deviation if known (tau = lambda*(beta) sqrt(max(m,n)) * noise);
    when unknown, pass ``sigma`` (the singular values) and the noise
    level is calibrated from their median (tau = omega(beta) *
    median(sigma)). Keep singular values > tau.
    """
    m, n = int(shape[0]), int(shape[1])
    beta = min(m, n) / max(m, n)
    if noise is not None:
        return _lambda_star(beta) * np.sqrt(max(m, n)) * float(noise)
    if sigma is None:
        raise ValueError("need either noise= (known level) or sigma= "
                         "(singular values, for median calibration)")
    return _omega_approx(beta) * float(np.median(_host_f64(sigma)))


def select_rank(sigma, shape, noise: float | None = None) -> int:
    """Number of singular values above the Gavish-Donoho threshold.

    sigma: computed singular values (any length, typically from a
    generous-rank :func:`random_svd`); shape: the ORIGINAL data shape.
    NOTE with truncated spectra and unknown noise, the median of the
    retained sigma overestimates the noise only if the truncation rank
    is much larger than the true rank: pass at least ~4x the expected
    rank.
    """
    sig = _host_f64(sigma)
    tau = svht_threshold(shape, noise=noise,
                         sigma=None if noise is not None else sig)
    return int(np.sum(sig > tau))


def _probe_norms(a, q, n_probes, key) -> torch.Tensor:
    """max_i ||(I - Q Q^T) A w_i||_2 over standard Gaussian probes, as a
    0-d tensor on a's device."""
    w = _rsvd._draw_sketch(key, (a.shape[1], n_probes), a.dtype, a.device)
    y = a @ w
    y = y - q @ (q.mT @ y)
    return torch.linalg.vector_norm(y, dim=0).max()


def range_error_estimate(a, q, n_probes: int = 10, key=0) -> float:
    """A-posteriori estimate of ||(I - Q Q^T) A||_2 (HMT 2011, eq.
    4.3): with probability >= 1 - 10^-n_probes the true norm is at most
    ``10 sqrt(2/pi)`` times the returned max-probe norm. NOTE the probe
    norm ||B w||_2 concentrates near ||B||_F for Gaussian w, so on FLAT
    residual spectra (white noise tails) the estimate sits near the
    Frobenius norm: a CONSERVATIVE certificate for the 2-norm. Set
    tolerances accordingly (it certifies total residual energy, which
    is usually what reconstruction accuracy means anyway)."""
    a = as_tensor(a)
    q = as_tensor(q, device=a.device)
    if q.shape[0] != a.shape[0]:
        raise ValueError(
            f"q must be ({a.shape[0]}, r), got {tuple(q.shape)}"
        )
    return float(_probe_norms(a, q, int(n_probes), key))


def adaptive_random_svd(a, tol: float, rank0: int = 8,
                        max_rank: int | None = None, n_iter: int = 4,
                        n_probes: int = 10, n_oversamples: int = 8,
                        key=0):
    """Randomized SVD with the rank chosen to meet a spectral-norm
    tolerance: doubles the rank until the HMT probe estimate of
    ||A - Q Q^T A||_2 falls below ``tol`` (absolute), then returns
    (u, s, vt, rank, err_estimate). The estimate stays on the device and
    is read once a round.
    """
    a = as_tensor(a)
    if a.ndim != 2:
        raise ValueError(f"a must be 2-d, got {a.ndim}-d")
    if tol <= 0:
        raise ValueError(f"tol must be > 0, got {tol}")
    m, n = int(a.shape[0]), int(a.shape[1])
    cap = min(m, n) if max_rank is None else min(int(max_rank), m, n)
    r = max(1, min(int(rank0), cap))
    k_svd, k_probe = _rsvd._split_seed(key, 2, a.device)
    while True:
        # a generator runs on, so each round draws from a copy of the two
        # children: the same sketch at every rank, as a key gives
        u, s, vt = _rsvd.random_svd(a, r, int(n_iter), int(n_oversamples),
                                    key=_again(k_svd))
        err = float(_probe_norms(a, u, int(n_probes), _again(k_probe)))
        if err <= float(tol) or r >= cap:
            return u, s, vt, r, err
        r = min(2 * r, cap)


def _again(key):
    """A generator at ``key``'s starting point (anything else is passed
    through), so that a draw can be repeated."""
    if isinstance(key, torch.Generator):
        return key.clone_state().manual_seed(key.initial_seed())
    return key
