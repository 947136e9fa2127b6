"""Functional public API mirroring the reference pyo3 module ``corrla_rs``.

Counterpart of ``corrla_rs_tpu/api.py``: the same signatures and return
shapes (singular values as (r, 1) columns, as the pyo3 layer returns them),
plus a ``device`` for numpy inputs (default:
``utils.device.default_device()``; tensors stay where they are). ``seed``
is an int or a ``torch.Generator``.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.models.pca import PcaRsvd
from corrla_rs_tpu_torch.ops.random_svd import random_svd
from corrla_rs_tpu_torch.utils.debug import guard_finite
from corrla_rs_tpu_torch.utils.device import as_tensor, default_device
from corrla_rs_tpu_torch.utils.prng import split_seed

__all__ = ["rsvd", "rpca", "active_ss", "cs_dirichlet_sample",
           "cs_mcmc_dirichlet_sample", "SAMPLER_CHAINS"]

# below this many seed chains, cs_mcmc_dirichlet_sample with an int seed and
# the CPU as its device runs the C++ host pipeline (the JAX package's
# utils.smallpath constant)
SAMPLER_CHAINS = 512


@guard_finite
def rsvd(a_mat, n_rank: int, n_iters: int, n_oversamples: int, seed=0,
         device=None):
    """Randomized SVD. Parity with pyfn rsvd (lib_math_utils_py.rs:21-36).

    Returns (U (m, r), S (r, 1), Vt (r, n)).
    """
    a = as_tensor(a_mat, device=device)
    u, s, vt = random_svd(a, n_rank, n_iters, n_oversamples, key=seed)
    return u, s[:, None], vt


@guard_finite
def rpca(a_mat, n_rank: int, n_iters: int = None, n_oversamples: int = None,
         seed=0, device=None):
    """PCA via RSVD. Parity with pyfn rpca (lib_math_utils_py.rs:38-55).

    Like the reference binding, ``n_iters``/``n_oversamples`` are accepted
    but the PCA model uses its own defaults (pca_rsvd.rs:65-66). Returns
    (singular_values (r, 1), components (r, n_dim)).
    """
    pca = PcaRsvd(a_mat, n_rank, key=seed, device=device)
    return pca.singular_values[:, None], pca.components


@guard_finite
def active_ss(x, y, order: int, n_nbr: int, n_comps: int, device=None):
    """Active-subspace id + sensitivity. Parity with pyfn active_ss
    (lib_math_utils_py.rs:57-87): local-poly gradient estimator (kNN on the
    distance-tile kernel), the EVD ``fit`` path, Constantine-Diaz
    sensitivities.

    Returns (components (k, n_comps), singular_vals (k, n_comps),
    sensi (k,)).
    """
    from corrla_rs_tpu_torch.models.active_subspaces import (
        ActiveSsRsvd,
        PolyGradientEstimator,
    )

    x = as_tensor(x, device=device)
    y = as_tensor(y, device=x.device)
    grad_est = PolyGradientEstimator(x, y, order, n_nbr)
    fitted = ActiveSsRsvd(grad_est, n_comps).fit(x)
    return fitted.components, fitted.singular_vals, fitted.var_diag_evd_sensi()


@guard_finite
def cs_dirichlet_sample(bounds, n_samples: int, max_zshots: int,
                        chunk_size: int, c_scale: float, alphas, seed=0,
                        device=None):
    """Constrained Dirichlet rejection sampling. Parity with pyfn
    cs_dirichlet_sample (lib_math_utils_py.rs:89-105)."""
    from corrla_rs_tpu_torch.ops.samplers import constr_dirichlet_sample

    return constr_dirichlet_sample(bounds, n_samples, max_zshots, chunk_size,
                                   c_scale, alphas, key=seed, device=device)


@guard_finite
def cs_mcmc_dirichlet_sample(bounds, n_samples: int, n_seed_samples: int,
                             max_zshots: int, chunk_size: int, c_scale: float,
                             alphas, gamma: float, var_epsilon: float, seed=0,
                             device=None):
    """Hybrid rejection-seeded DEMC sampling of the bounded simplex.

    Full-pipeline parity with pyfn cs_mcmc_dirichlet_sample
    (lib_math_utils_py.rs:107-168): rejection seeds -> Dirichlet(1) target
    x uniform box prior -> simplex-renormalizing proposal fixup -> parallel
    DEMC -> (interleaved samples, acceptance ratio). One chain per seed, so
    n_seed_samples >= 3.

    The samplers run on ``device`` (default
    ``utils.device.default_device()``) and the samples are a tensor there.
    When that device is the CPU, an int ``seed`` and fewer than
    ``SAMPLER_CHAINS`` seed chains take the compiled C++ host pipeline of
    ``native.py`` instead, when it is available, as the JAX package does for
    small populations, and the samples come back as a numpy array. Same
    statistical contract; the two routes draw differently.
    """
    from corrla_rs_tpu_torch import native
    from corrla_rs_tpu_torch.ops.samplers import (
        DeMcSampler,
        constr_dirichlet_sample,
        ln_like_dirichlet,
        ln_like_sum,
        ln_prior_uniform,
    )

    bounds = np.asarray(bounds, dtype=np.float64)
    dev = torch.device(device) if device is not None else default_device()
    if (dev.type == "cpu" and isinstance(seed, (int, np.integer))
            and int(n_seed_samples) < SAMPLER_CHAINS
            and native.available()):
        seeds = native.cs_dirichlet_rejection_host(
            bounds, int(n_seed_samples), int(max_zshots), int(chunk_size),
            float(c_scale), alphas, seed=int(seed) * 2 + 1,
        )
        return native.demc_dirichlet_host(
            bounds, seeds, int(n_samples), gamma=float(gamma),
            var_epsilon=float(var_epsilon), c_scale=float(c_scale),
            alphas=np.ones(bounds.shape[0]),  # Dirichlet(1) target
            seed=int(seed) * 2 + 2,
        )

    k_seed, k_mcmc = split_seed(seed, 2, dev)
    seeds = constr_dirichlet_sample(
        bounds, n_seed_samples, max_zshots, chunk_size, c_scale, alphas,
        key=k_seed, device=dev,
    )
    # target is uniform-in-z Dirichlet(1,...,1) (lib_math_utils_py.rs:129)
    ndim = bounds.shape[0]
    ln_post = ln_like_sum(ln_like_dirichlet(np.ones(ndim)),
                          ln_prior_uniform(bounds))

    def fixup(x):
        return c_scale * x / torch.sum(x)

    sampler = DeMcSampler(ln_post, seeds, gamma, var_epsilon,
                          prop_fixup_fn=fixup, key=k_mcmc)
    sampler.sample_mcmc(n_samples)
    return sampler.get_samples(n_samples), sampler.accept_ratio()
