"""Stochastic trace estimation: Hutchinson and Hutch++.

Counterpart of ``corrla_rs_tpu/ops/trace_est.py`` (no reference analogue).
tr(A) for matrices only available through products (kernel Grams, covariance
products, Hessians of the library's surrogates) or too large to form densely.
Hutchinson (1989) averages x^T A x over Rademacher probes: error ~ ||A||_F /
sqrt(k). Hutch++ (Meyer, Musco, Musco & Woodruff 2021) first captures A's
dominant range with a randomized QB step and applies Hutchinson only to the
(small) residual: error ~ tr(A)/k on PSD matrices, a quadratic improvement
that makes tiny probe budgets useful.

Probes are drawn as ONE (n, k) Rademacher block, and every step is a dense
(n, n) x (n, k) product. Both estimators return a Python float, read from
the device once. ``hutchpp_trace`` also accepts a matvec CALLABLE for
matrix-free operators (the probe block goes through a single call: supply a
function that maps (n, k) -> (n, k)).
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.ops.mat_utils import apply_operator as _apply
from corrla_rs_tpu_torch.utils.device import as_tensor, default_device
from corrla_rs_tpu_torch.utils.prng import as_generator

__all__ = ["hutchinson_trace", "hutchpp_trace"]


def _rademacher(key, shape, dtype, device) -> torch.Tensor:
    """A block of +-1 with equal probability: the one place the trace and
    quadrature estimators draw their probes."""
    gen = as_generator(key, device)
    bits = torch.randint(0, 2, shape, generator=gen, device=device)
    return (2 * bits - 1).to(dtype)


def hutchinson_trace(a, n_probes: int = 64, key=0) -> float:
    """Plain Hutchinson estimate of tr(A): mean of x^T A x over
    Rademacher probes (error ~ ||A||_F / sqrt(n_probes)). ``a`` must
    be an explicit (n, n) matrix; for matrix-free operators use
    :func:`hutchpp_trace` with a callable and ``n_dim=``."""
    if n_probes < 1:
        raise ValueError(f"n_probes must be >= 1, got {n_probes}")
    if callable(a):
        raise TypeError(
            "hutchinson_trace needs an explicit matrix; use "
            "hutchpp_trace(a, n_dim=...) for callables"
        )
    a = as_tensor(a)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a must be square, got {tuple(a.shape)}")
    x = _rademacher(key, (int(a.shape[0]), int(n_probes)), a.dtype, a.device)
    return float(torch.sum(x * (a @ x)) / n_probes)


def hutchpp_trace(a, n_probes: int = 64, key=0,
                  n_dim: int | None = None, dtype=None) -> float:
    """Hutch++ estimate of tr(A) with a total budget of ``n_probes``
    operator-block applications' worth of probes (split 1/3 sketch,
    1/3 range refinement via QR, 1/3 residual Hutchinson, as in the
    paper). ``a``: (n, n) matrix or batched matvec callable
    (n, k) -> (n, k). Callables must pass ``n_dim``; their probes are
    ``dtype`` (default ``torch.get_default_dtype()``) on the default device.
    PSD error ~ tr(A) / n_probes."""
    if n_probes < 3:
        raise ValueError(f"n_probes must be >= 3, got {n_probes}")
    if callable(a):
        if n_dim is None:
            raise ValueError("callable operators need n_dim=")
        n = int(n_dim)
        dt = dtype if dtype is not None else torch.get_default_dtype()
        dev = default_device()
    else:
        a = as_tensor(a)
        if a.ndim != 2 or a.shape[0] != a.shape[1]:
            raise ValueError(f"a must be square, got {tuple(a.shape)}")
        n = int(a.shape[0])
        dt = a.dtype if dtype is None else dtype
        dev = a.device
    k = max(int(n_probes) // 3, 1)
    k_sketch, k_resid = _rsvd._split_seed(key, 2, dev)
    s = _rademacher(k_sketch, (n, k), dt, dev)
    q = torch.linalg.qr(_apply(a, s)).Q          # (n, k) range basis
    # exact trace on the captured range: tr(Q^T A Q)
    aq = _apply(a, q)
    t_range = torch.sum(q * aq)
    # Hutchinson on the residual (I - QQ^T) A (I - QQ^T)
    g = _rademacher(k_resid, (n, k), dt, dev)
    g = g - q @ (q.mT @ g)
    ag = _apply(a, g)
    ag = ag - q @ (q.mT @ ag)
    t_resid = torch.sum(g * ag) / k
    return float(t_range + t_resid)
