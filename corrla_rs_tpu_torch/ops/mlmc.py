"""Multilevel Monte Carlo (MLMC).

Counterpart of ``corrla_rs_tpu/ops/mlmc.py`` (Giles 2008, 2015): the
telescoping sum E[P_L] = E[P_0] + sum_l E[P_l - P_{l-1}] over refinement
levels, each correction estimated on coupled pairs (the same inputs through
both levels), with the classic two-stage allocation: pilot pairs estimate
V_l, and n_l ~ sqrt(V_l / C_l) tops each level up.

Each batch of inputs comes from the user's ``sample_inputs(gen, n)``, which
gets a ``torch.Generator`` where the JAX package passes a key: the run's
2(L+1) generators are the children of ``key`` (``ops.random_svd.
_split_seed``, as the JAX package splits its key), pilot draws from the
first L+1, top-ups from the rest. Each level evaluates as one batched call;
the running sums are host float64, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import _host_f64, as_tensor, \
    default_device

__all__ = ["MlmcResult", "mlmc_estimate"]


class MlmcResult(NamedTuple):
    mean: float                # the multilevel estimate of E[P_L]
    std_error: float           # estimated standard error
    n_per_level: np.ndarray    # (L+1,) samples actually used
    level_means: np.ndarray    # (L+1,) correction means Y_l
    level_vars: np.ndarray     # (L+1,) correction variances V_l
    total_cost: float          # sum n_l * cost_l


def mlmc_estimate(level_fns: Sequence[Callable], sample_inputs: Callable,
                  costs, target_se: float | None = None,
                  n_pilot: int = 64, n_max: int = 1_000_000,
                  bucket_sizes: bool = True, key=0,
                  device=None) -> MlmcResult:
    """Multilevel estimate of E[level_fns[-1](X)].

    level_fns: callables, coarse -> fine; ``level_fns[l](x)`` maps a
        batch (n, d) -> (n,). COUPLING is by common inputs: correction
        l averages P_l(x) - P_{l-1}(x) on the SAME x draws (for SDE-type
        problems encode the common randomness in x, e.g. the Brownian
        increments at the finest resolution, and let each level
        coarsen internally).
    sample_inputs: (gen, n) -> (n, d), where gen is a ``torch.Generator``
        on ``device`` (default ``utils.device.default_device()``): the JAX
        package passes a key here.
    costs: (L+1,) cost per evaluation of each level (the correction at
        level l is charged cost_l + cost_{l-1}).
    target_se: desired standard error (warns if n_max clips the
        allocation below it); with None, ``n_max`` is an APPROXIMATE
        total-cost budget — pilot cost is subtracted before allocating,
        but per-level pilot floors and bucketing may overshoot the
        realized cost by up to ~2x.
    bucket_sizes: round every top-up batch UP to a power of two (kept
        from the JAX package, where each distinct batch shape compiles a
        program of its own); the extra samples only improve the SE.

    Returns an MlmcResult; unbiased for E[P_L] by the telescoping sum.
    """
    n_levels = len(level_fns)
    if n_levels < 1:
        raise ValueError("need at least one level")
    costs = np.asarray(costs, np.float64)
    if costs.shape[0] != n_levels:
        raise ValueError(f"costs must have {n_levels} entries")
    corr_cost = costs.copy()
    corr_cost[1:] += costs[:-1]           # pairs evaluate two levels
    dev = torch.device(device) if device is not None else default_device()

    def corrections(k, n, lvl):
        x = sample_inputs(k, int(n))
        fine = as_tensor(level_fns[lvl](x), device=dev).reshape(-1)
        if lvl == 0:
            return _host_f64(fine)
        coarse = as_tensor(level_fns[lvl - 1](x), device=dev).reshape(-1)
        return _host_f64(fine - coarse)

    # -- pilot --
    keys = _rsvd._split_seed(key, 2 * n_levels, dev)
    sums = np.zeros(n_levels)
    sq_sums = np.zeros(n_levels)
    counts = np.zeros(n_levels, np.int64)
    for lvl in range(n_levels):
        y = corrections(keys[lvl], n_pilot, lvl)
        sums[lvl] = y.sum()
        sq_sums[lvl] = (y ** 2).sum()
        counts[lvl] = y.shape[0]
    v = np.maximum(sq_sums / counts - (sums / counts) ** 2, 1e-300)

    # -- optimal allocation: n_l ~ sqrt(V_l / C_l) --
    lam = np.sum(np.sqrt(v * corr_cost))
    if target_se is not None:
        n_opt = np.ceil(lam * np.sqrt(v / corr_cost)
                        / target_se ** 2).astype(np.int64)
        if np.any(n_opt > n_max):
            import warnings

            warnings.warn(
                f"MLMC: optimal allocation {n_opt.max()} exceeds "
                f"n_max={n_max}; the requested target_se will be "
                "missed (raise n_max)", stacklevel=2)
    else:
        # budget mode: spend (n_max - pilot cost) on the allocation;
        # per-level pilot floors and power-of-two bucketing can still
        # overshoot the target by up to ~2x (documented)
        budget = max(float(n_max) - float(np.dot(counts, corr_cost)),
                     0.0)
        n_opt = np.ceil(budget * np.sqrt(v / corr_cost)
                        / lam).astype(np.int64)
    n_opt = np.minimum(np.maximum(n_opt, n_pilot), n_max)

    # -- top-up --
    for lvl in range(n_levels):
        extra = int(n_opt[lvl] - counts[lvl])
        if extra > 0 and bucket_sizes:
            extra = 1 << (extra - 1).bit_length()
        if extra > 0:
            y = corrections(keys[n_levels + lvl], extra, lvl)
            sums[lvl] += y.sum()
            sq_sums[lvl] += (y ** 2).sum()
            counts[lvl] += y.shape[0]

    means = sums / counts
    v = np.maximum(sq_sums / counts - means ** 2, 0.0)
    est = float(means.sum())
    se = float(np.sqrt(np.sum(v / counts)))
    return MlmcResult(
        mean=est, std_error=se, n_per_level=counts,
        level_means=means, level_vars=v,
        total_cost=float(np.dot(counts, corr_cost)),
    )
