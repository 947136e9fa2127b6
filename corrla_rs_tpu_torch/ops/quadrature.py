"""Gauss and Smolyak sparse-grid quadrature.

Counterpart of ``corrla_rs_tpu/ops/quadrature.py``: 1-d Gauss rules, full
tensor grids and the Smolyak combination technique (Smolyak 1963; Gerstner &
Griebel 1998), whose point count grows polynomially in d,

    A(q, d) = sum_{q-d+1 <= |k|_1 <= q} (-1)^(q-|k|) C(d-1, q-|k|)
              (Q_{k_1} x ... x Q_{k_d})

with nested Clenshaw-Curtis 1-d rules (m_1 = 1, m_k = 2^(k-1) + 1) by
default, or Gauss-Legendre / Gauss-Hermite. Nodes and weights are built on
the host in numpy, as in the JAX package; ``integrate`` evaluates the
integrand once over all nodes on the device with ``torch.func.vmap`` and
reduces with the weights.
"""
from __future__ import annotations

import itertools
from math import comb
from typing import Callable, NamedTuple

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["QuadratureRule", "gauss_legendre", "gauss_hermite",
           "clenshaw_curtis", "tensor_quadrature", "smolyak_quadrature",
           "integrate"]

# What torch.func.vmap raises for a callable it cannot trace: a Python
# scalar or a numpy array taken of a batched tensor (``float(x)``, ``.item()``,
# ``np.asarray(x)``), or data-dependent control flow. These, and TypeError,
# send ``integrate`` to its per-node loop, where the JAX package catches
# TracerArrayConversionError, ConcretizationTypeError and TypeError. Any other
# error, a CUDA failure included, propagates.
_UNTRACEABLE = (
    "vmap: It looks like you're calling .item()",
    "vmap: It looks like you're attempting to use a Tensor in some "
    "data-dependent control flow",
    "Cannot access data pointer of Tensor that doesn't have storage",
)


def _untraceable(err: Exception) -> bool:
    """Whether ``err`` says the callable cannot run under vmap."""
    if isinstance(err, TypeError):
        return True
    return isinstance(err, RuntimeError) and any(
        msg in str(err) for msg in _UNTRACEABLE)


class QuadratureRule(NamedTuple):
    nodes: np.ndarray      # (n, d) — or (n, 1) for 1-d rules
    weights: np.ndarray    # (n,)


def gauss_legendre(n: int, a: float = -1.0, b: float = 1.0
                   ) -> QuadratureRule:
    """n-point Gauss-Legendre on [a, b]: exact for degree <= 2n-1."""
    x, w = np.polynomial.legendre.leggauss(int(n))
    x = 0.5 * (b - a) * x + 0.5 * (b + a)
    w = 0.5 * (b - a) * w
    return QuadratureRule(x[:, None], w)


def gauss_hermite(n: int) -> QuadratureRule:
    """n-point Gauss-Hermite for the STANDARD NORMAL weight (integrals
    E[f(X)], X ~ N(0,1)): exact for polynomial f of degree <= 2n-1."""
    x, w = np.polynomial.hermite_e.hermegauss(int(n))
    return QuadratureRule(x[:, None], w / np.sqrt(2.0 * np.pi))


def clenshaw_curtis(n: int, a: float = -1.0, b: float = 1.0
                    ) -> QuadratureRule:
    """n-point Clenshaw-Curtis on [a, b] (n odd nests: the level-k
    Smolyak rule m_k = 2^(k-1)+1 reuses every coarser level's nodes).
    Exact for degree <= n-1."""
    n = int(n)
    if n == 1:
        x = np.array([0.0])
        w = np.array([2.0])
    else:
        m = n - 1
        theta = np.pi * np.arange(n) / m
        x = np.cos(theta)[::-1]
        # exact CC weights via the cosine-sum formula
        w = np.zeros(n)
        for i in range(n):
            s = 1.0
            for j in range(1, m // 2 + 1):
                factor = 1.0 if 2 * j != m else 0.5
                s -= factor * 2.0 * np.cos(2.0 * j * theta[i]) \
                    / (4.0 * j * j - 1.0)
            w[i] = 2.0 * s / m
        w[0] *= 0.5
        w[-1] *= 0.5
        w = w[::-1].copy()
    x = 0.5 * (b - a) * x + 0.5 * (b + a)
    w = 0.5 * (b - a) * w
    return QuadratureRule(x[:, None], w)


_1D_RULES = {
    "clenshaw_curtis": lambda m: clenshaw_curtis(m),
    "gauss_legendre": lambda m: gauss_legendre(m),
    "gauss_hermite": lambda m: gauss_hermite(m),
}


def tensor_quadrature(rules) -> QuadratureRule:
    """Full tensor product of 1-d rules: exact whenever each factor is,
    but n = prod(n_i) — use for small d only."""
    nodes_1d = [np.asarray(r.nodes).ravel() for r in rules]
    weights_1d = [np.asarray(r.weights) for r in rules]
    grids = np.meshgrid(*nodes_1d, indexing="ij")
    nodes = np.stack([g.ravel() for g in grids], axis=1)
    w = weights_1d[0]
    for wi in weights_1d[1:]:
        w = np.multiply.outer(w, wi).ravel()
    return QuadratureRule(nodes, w)


def _cc_size(k: int) -> int:
    return 1 if k == 1 else 2 ** (k - 1) + 1


def smolyak_quadrature(n_dim: int, level: int,
                       rule: str = "clenshaw_curtis") -> QuadratureRule:
    """Smolyak sparse grid over [-1,1]^d (or Gaussian measure for
    'gauss_hermite').

    level >= 0: level 0 is the single-point rule; each level roughly
    doubles the 1-d resolution while the point count grows like
    O(2^level * n_dim^level / level!) — polynomial in dimension.
    Duplicate nodes from the nested construction are merged (weights
    summed), so the advertised point economy is real.
    """
    if rule not in _1D_RULES:
        raise ValueError(f"unknown rule {rule!r}; pick from "
                         f"{sorted(_1D_RULES)}")
    d = int(n_dim)
    q = int(level) + d
    if level < 0:
        raise ValueError(f"level must be >= 0, got {level}")
    make = _1D_RULES[rule]
    size = _cc_size if rule == "clenshaw_curtis" else (lambda k: k)
    rules_1d = {}

    def rule_k(k):
        if k not in rules_1d:
            rules_1d[k] = make(size(k))
        return rules_1d[k]

    all_nodes = []
    all_weights = []
    lo = max(q - d + 1, d)
    for total in range(lo, q + 1):
        coeff = (-1.0) ** (q - total) * comb(d - 1, q - total)
        # compositions of `total` into d parts, each >= 1
        for cuts in itertools.combinations(range(1, total), d - 1):
            ks = np.diff((0,) + cuts + (total,))
            tq = tensor_quadrature([rule_k(int(k)) for k in ks])
            all_nodes.append(tq.nodes)
            all_weights.append(coeff * tq.weights)
    nodes = np.concatenate(all_nodes)
    weights = np.concatenate(all_weights)
    # merge duplicates (nested rules repeat nodes across terms)
    key = np.round(nodes / 1e-12).astype(np.int64)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True,
                               return_counts=True)
    merged_nodes = np.zeros((counts.shape[0], d))
    merged_w = np.zeros(counts.shape[0])
    np.add.at(merged_w, inv, weights)
    # representative node per group (they are identical up to rounding)
    merged_nodes[inv] = nodes
    keep = np.abs(merged_w) > 1e-300
    return QuadratureRule(merged_nodes[keep], merged_w[keep])


def integrate(fn: Callable, rule: QuadratureRule, device=None) -> float:
    """Integrate with one batched evaluation: sum_i w_i f(x_i).

    ``fn`` maps a (d,) point to a scalar. A torch-traceable callable runs
    once under ``torch.func.vmap`` over all nodes on ``device`` (default
    ``utils.device.default_device()``); a plain Python/numpy callable, which
    vmap cannot trace (``_UNTRACEABLE``), is called node by node on float64
    host rows instead, as the JAX package falls back to an eager loop.
    """
    nodes = as_tensor(np.asarray(rule.nodes, np.float64), device=device)
    w = np.asarray(rule.weights)
    try:
        vals = torch.func.vmap(fn)(nodes)
    except (RuntimeError, TypeError) as err:
        if not _untraceable(err):
            raise
    else:
        vals = as_tensor(vals, device=nodes.device).reshape(-1)
        return float(torch.dot(torch.as_tensor(w, dtype=vals.dtype,
                                               device=vals.device), vals))
    vals = np.asarray([float(fn(p)) for p in nodes.cpu()])
    return float(np.dot(w, vals))
