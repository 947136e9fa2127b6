"""MCMC convergence diagnostics.

Counterpart of ``corrla_rs_tpu/ops/diagnostics.py``. The reference's only
sampler metric is the global acceptance ratio (space_samplers.rs:396-398).
These are the standard convergence checks over the (n_generations, n_chains,
ndim) histories that DeMcSampler and DreamSampler produce:

- ``gelman_rubin``: split-chain potential-scale-reduction R-hat
  (Gelman et al., BDA3 / Vehtari et al. 2021 split-R-hat).
- ``effective_sample_size``: autocorrelation-based ESS via FFT
  (Geyer initial positive sequence).
- ``rank_normalized_rhat``: the Vehtari et al. 2021 rank-normalized +
  folded split-R-hat (catches scale-only mixing failures and heavy
  tails that plain R-hat misses).

A history that is a tensor is worked on where it lies; anything else goes to
``utils.device.default_device()``. The JAX package computes the last two on
the host with numpy; here they are float64 tensor operations on the
history's device (an FFT, a sort), and only the short Geyer sum runs on the
host, after one read a dimension.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["gelman_rubin", "effective_sample_size", "rank_normalized_rhat"]


def _split_chains(history):
    """(n, m, d) -> (n//2, 2m, d): split each chain in half (split R-hat)."""
    n = (history.shape[0] // 2) * 2
    h = history[:n]
    return torch.cat([h[: n // 2], h[n // 2:]], dim=1)


def gelman_rubin(history) -> torch.Tensor:
    """Split-chain R-hat per dimension; values near 1 indicate convergence.

    Args:
      history: (n_generations, n_chains, ndim) chain samples (post burn-in).
    Returns:
      (ndim,) potential scale reduction factors.
    """
    h = _split_chains(as_tensor(history))
    n, m, _d = h.shape
    chain_means = torch.mean(h, dim=0)              # (m, d)
    grand_mean = torch.mean(chain_means, dim=0)     # (d,)
    b = n / (m - 1.0) * torch.sum(
        (chain_means - grand_mean[None, :]) ** 2, dim=0
    )
    w = torch.mean(torch.var(h, dim=0, correction=1), dim=0)  # within-chain
    var_plus = (n - 1.0) / n * w + b / n
    return torch.sqrt(var_plus / w)


def effective_sample_size(history) -> torch.Tensor:
    """ESS per dimension via FFT autocorrelation (Geyer truncation).

    Args:
      history: (n_generations, n_chains, ndim).
    Returns:
      (ndim,) effective sample sizes (total across chains), float64.
    """
    h = as_tensor(history).to(torch.float64)
    n, m, d = h.shape
    x = h - h.mean(dim=0, keepdim=True)
    nfft = 1 << max(2 * n - 1, 1).bit_length()
    f = torch.fft.rfft(x, n=nfft, dim=0)
    acov = torch.fft.irfft(f * f.conj(), n=nfft, dim=0)[:n]
    acov = acov / torch.arange(n, 0, -1, dtype=h.dtype,
                               device=h.device)[:, None, None]
    # chain-averaged autocorrelation (Vehtari et al. combine W and B). As
    # in the JAX package the between-chain term is taken of the CENTERED
    # chains' means, which are 0 to rounding, so it adds nothing
    w = acov[0].mean(dim=0)                                        # (d,)
    var_plus = w * (n - 1) / n + torch.var(
        x.mean(dim=0), dim=0, correction=1 if m > 1 else 0)
    rho = 1.0 - (w[None, :] - acov[1:].mean(dim=1)) / var_plus[None, :]
    ess = []
    for row in rho.T.tolist():
        # Geyer initial positive sequence over pairs
        tau = 1.0
        for t in range(0, len(row) - 1, 2):
            pair = row[t] + row[t + 1]
            if pair < 0:
                break
            tau += 2.0 * pair
        ess.append(n * m / tau)
    return torch.tensor(ess, dtype=torch.float64, device=h.device)


def _rank_normal(x: torch.Tensor) -> torch.Tensor:
    """(n, m, d) draws -> their rank-normalized z-scores, each dimension
    ranked over its pooled draws.

    AVERAGE ranks (MCMC histories are tie-heavy: every rejection duplicates
    the previous draw; position-based ranks would split tie blocks
    systematically by chain and inflate R-hat on converged chains), Blom
    offset, standard-normal quantile transform. The 1-based average rank of
    a tie block of size c starting after s smaller values is s + (c + 1)/2.
    """
    n, m, d = x.shape
    out = torch.empty_like(x)
    for k in range(d):
        flat = x[:, :, k].reshape(-1)
        _uniq, inv, counts = torch.unique(flat, return_inverse=True,
                                          return_counts=True)
        counts = counts.to(x.dtype)   # an int tensor / 2.0 would be f32
        start = torch.cumsum(counts, dim=0) - counts
        ranks = (start + (counts + 1.0) / 2.0)[inv]
        z = torch.special.ndtri((ranks - 0.375) / (flat.numel() + 0.25))
        out[:, :, k] = z.reshape(n, m)
    return out


def rank_normalized_rhat(history) -> torch.Tensor:
    """Rank-normalized + folded split-R-hat (Vehtari et al. 2021).

    The modern convergence check: plain R-hat misses poor mixing when
    chains differ in scale but not location (and vice versa), and is
    distorted by heavy tails. This computes split-R-hat on rank-normalized
    draws (max of the bulk statistic and the folded statistic on
    |x - median|, which targets the tails). Convergence rule of thumb: max
    over dims < 1.01.

    Args:
      history: (n_generations, n_chains, ndim) post burn-in.
    Returns:
      (ndim,) rank-normalized R-hat values, float64.
    """
    h = as_tensor(history).to(torch.float64)
    n, m, d = h.shape
    bulk = gelman_rubin(_rank_normal(h))
    # numpy's median: the mean of the two middle values for an even count.
    # A sort a dimension: torch.quantile refuses more than 2^24 elements,
    # which 4,096 chains pass after 4,096 generations
    pooled = h.reshape(n * m, d)
    lo, hi = (n * m - 1) // 2, (n * m) // 2
    median = torch.stack([
        0.5 * (col[lo] + col[hi])
        for col in (torch.sort(pooled[:, k]).values for k in range(d))])
    tail = gelman_rubin(_rank_normal((h - median[None, None, :]).abs()))
    return torch.maximum(bulk, tail)
