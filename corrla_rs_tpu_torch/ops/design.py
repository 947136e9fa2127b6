"""Space-filling sampling designs.

Counterpart of ``corrla_rs_tpu/ops/design.py``:

- ``latin_hypercube``: stratified LHS (one permutation and one uniform per
  dimension), optionally maximin-improved by keeping the best of
  ``n_candidates`` designs by minimum pairwise distance, all candidates
  drawn and scored as one batch;
- ``sobol_sample``: scrambled Sobol' points from ``scipy.stats.qmc``;
- ``halton_sample``: scrambled Halton points, the same way.

All return float64 points in the user's box, (n, d), on ``device``
(default ``utils.device.default_device()``). The permutations and uniforms
come from one seam, ``_draw_lhs``, and the scipy seed from another,
``_seed_from_key``; the parity tests replace both with the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import default_device
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["latin_hypercube", "sobol_sample", "halton_sample"]


def _box(bounds, device):
    """(d, lo, span) from a (d, 2) bounds array, float64 on ``device``."""
    bounds = np.asarray(bounds, dtype=np.float64)
    lo = torch.as_tensor(bounds[:, 0], device=device)
    span = torch.as_tensor(bounds[:, 1] - bounds[:, 0], device=device)
    return bounds.shape[0], lo, span


def _device(device) -> torch.device:
    return torch.device(device) if device is not None else default_device()


def _seed_from_key(key) -> int:
    """The scipy.qmc integer seed of a key.

    An int seed gives what the JAX package derives from
    ``jax.random.key(seed)``: its two 32-bit words, high then low, read as
    one little-endian integer (mod 2^63). A ``torch.Generator`` gives its
    initial seed, so a key used twice gives the same plan.
    """
    if isinstance(key, torch.Generator):
        return key.initial_seed() % (2**63)
    seed = int(key) % (2**64)
    words = np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)
    return int.from_bytes(words.tobytes(), "little") % (2**63)


def _draw_lhs(key, n_candidates: int, n: int, d: int, device):
    """The permutations (c, d, n) int64 and uniforms (c, d, n) float64 of
    ``c = max(n_candidates, 1)`` designs: the one place the LHS draws."""
    c = max(int(n_candidates), 1)
    gen = as_generator(key, device)
    perms = torch.argsort(torch.rand((c, d, n), generator=gen,
                                     device=device), dim=-1)
    u = torch.rand((c, d, n), generator=gen, dtype=torch.float64,
                   device=device)
    return perms, u


def latin_hypercube(bounds, n_samples: int, key=0, n_candidates: int = 1,
                    device=None):
    """Latin hypercube sample over a box: every 1-D projection hits every
    one of the ``n_samples`` strata exactly once.

    n_candidates > 1 draws that many independent designs and keeps the one
    with the largest minimum pairwise distance (maximin criterion).
    """
    dev = _device(device)
    d, lo, span = _box(bounds, dev)
    n = int(n_samples)
    perms, u = _draw_lhs(key, n_candidates, n, d, dev)
    cands = ((perms + u) / n).mT                      # (c, n, d) in [0, 1)
    if n_candidates <= 1:
        unit = cands[0]
    else:
        d2 = torch.sum((cands[:, :, None, :] - cands[:, None, :, :]) ** 2,
                       dim=-1)
        # mask the diagonal with where, not + eye * inf (0 * inf is NaN)
        eye = torch.eye(n, dtype=torch.bool, device=dev)
        d2 = torch.where(eye, torch.inf, d2)
        scores = d2.amin(dim=(1, 2))
        unit = cands[torch.argmax(scores)]
    return lo + unit * span


def _qmc(engine, bounds, n_samples: int, key, device):
    dev = _device(device)
    d, lo, span = _box(bounds, dev)
    u = engine(d, scramble=True, seed=_seed_from_key(key)).random(
        int(n_samples))
    return lo + torch.as_tensor(u, device=dev) * span


def sobol_sample(bounds, n_samples: int, key=0, device=None):
    """Scrambled Sobol' low-discrepancy points in the box (a host plan from
    scipy.stats.qmc)."""
    from scipy.stats import qmc

    return _qmc(qmc.Sobol, bounds, n_samples, key, device)


def halton_sample(bounds, n_samples: int, key=0, device=None):
    """Scrambled Halton low-discrepancy points in the box."""
    from scipy.stats import qmc

    return _qmc(qmc.Halton, bounds, n_samples, key, device)
