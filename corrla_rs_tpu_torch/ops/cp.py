"""CP (canonical polyadic / PARAFAC) decomposition by ALS.

Counterpart of ``corrla_rs_tpu/ops/cp.py`` (no reference analogue; it
completes the tensor-format family next to Tucker/HOSVD, ``ops/hosvd``, and
the tensor train, ``ops/tt``).

CP writes a d-way tensor as a sum of R rank-one terms
T ~= sum_r lam_r a_r^(1) o ... o a_r^(d): the UNIQUE (under Kruskal
conditions) latent-factor model, which Tucker and TT are not, so CP factors
are interpretable axes (chemometrics, fluorescence, neural data).

Each ALS update solves all R columns of one factor at once from the
matricized-tensor-times-Khatri-Rao product (MTTKRP). The MTTKRP never forms
the Khatri-Rao matrix: the other factors are folded in one at a time with
batched products; the normal-equations Gram is the Hadamard product of the
small R x R factor Grams. A fixed number of sweeps runs in a host loop that
reads nothing from the device; the fit history is one device tensor.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["cp_als", "cp_reconstruct"]


def _mttkrp(t, factors, mode):
    """Matricized-tensor-times-Khatri-Rao along ``mode`` without forming
    the Khatri-Rao matrix: contract the tensor with every OTHER factor one
    axis at a time, keeping a trailing rank axis."""
    others = [k for k in range(t.ndim) if k != mode]
    cur = t.permute([mode] + others)         # (I_mode, others...)
    # each fold contracts the LAST tensor axis, so the other factors come
    # in REVERSE axis order; the rank axis appears with the first fold and
    # rides along elementwise afterwards
    rev = others[::-1]
    cur = cur @ factors[rev[0]]              # (..., R)
    for k in rev[1:]:
        cur = torch.sum(cur * factors[k], dim=-2)
    return cur                               # (I_mode, R)


def _hadamard_gram(grams, skip=None):
    g = torch.ones_like(grams[0])
    for k, gk in enumerate(grams):
        if k != skip:
            g = g * gk
    return g


def _cp_sweeps(t, factors, n_sweeps):
    d = t.ndim
    eps = torch.finfo(t.dtype).eps
    t_norm2 = torch.sum(t * t)
    eye = torch.eye(factors[0].shape[1], dtype=t.dtype, device=t.device)
    factors = list(factors)
    grams = [f.mT @ f for f in factors]
    fits = t.new_empty((n_sweeps,))
    for i in range(n_sweeps):
        for mode in range(d):
            g = _hadamard_gram(grams, skip=mode)
            m = _mttkrp(t, factors, mode)            # (I_mode, R)
            # ridge well above roundoff: over-ranked fits drive factor
            # columns collinear and make the Hadamard Gram numerically
            # singular; an eps-scale ridge lets the solve emit NaN
            reg = 100.0 * eps * torch.trace(g) / g.shape[0] + eps
            factors[mode] = torch.linalg.solve(g + reg * eye, m.mT).mT
            grams[mode] = factors[mode].mT @ factors[mode]
        # fit = 1 - ||T - That|| / ||T|| via the inner-product identity
        inner = torch.sum(_mttkrp(t, factors, d - 1) * factors[d - 1])
        that2 = torch.sum(_hadamard_gram(grams))
        err2 = torch.clamp_min(t_norm2 - 2.0 * inner + that2, 0.0)
        fits[i] = 1.0 - torch.sqrt(err2 / t_norm2)
    return factors, fits


def cp_als(tensor, rank: int, n_sweeps: int = 50, key=0,
           init: str = "svd", mesh=None):
    """Rank-``rank`` CP/PARAFAC fit of a d-way tensor by ALS.

    init: 'svd' (default: factors start from each unfolding's leading left
    singular vectors, the standard swamp-avoiding initialization; random
    init can stall in local minima) or 'random'. ``key`` is an int seed or
    a ``torch.Generator``; each mode draws from its own child.

    mesh: the JAX package's row sharding, not ported (anything but None
    raises).

    Returns (weights, factors, fits): ``weights`` (R,) positive scales
    (factors column-normalized, largest component first), ``factors`` a
    list of (I_k, R) matrices, ``fits`` (n_sweeps,) the fit history
    1 - ||T - T_hat||/||T|| (monotone up to roundoff; inspect it to judge
    convergence). Reconstruction via :func:`cp_reconstruct`.
    """
    if mesh is not None:
        raise NotImplementedError("cp_als(mesh=...) is not ported")
    t = as_tensor(tensor)
    if t.ndim < 2:
        raise ValueError(f"tensor must be >= 2-way, got {t.ndim}-way")
    r = int(rank)
    if r < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    if init not in ("svd", "random"):
        raise ValueError(f"init must be 'svd' or 'random', got {init!r}")
    if not bool(torch.any(t != 0)):
        # a zero tensor would divide the fit by ||T|| = 0 -> NaN
        zeros = [t.new_zeros((int(t.shape[k]), r)) for k in range(t.ndim)]
        return t.new_zeros((r,)), zeros, t.new_ones((int(n_sweeps),))
    keys = _rsvd._split_seed(key, t.ndim, t.device)
    factors = []
    for k in range(t.ndim):
        i_k = int(t.shape[k])
        if init == "random":
            factors.append(_rsvd._draw_sketch(keys[k], (i_k, r), t.dtype,
                                              t.device))
            continue
        unf = torch.movedim(t, k, 0).reshape(i_k, -1)
        r_k = min(r, i_k, int(unf.shape[1]))
        # the fold comes first: drawing from keys[k] would advance it
        pad_key = _rsvd._fold_seed(keys[k], 1, t.device) if r_k < r else None
        u, _, _ = _rsvd.random_svd(unf, r_k, 4, min(8, i_k), key=keys[k])
        if r_k < r:  # pad narrow modes with random columns
            pad = _rsvd._draw_sketch(pad_key, (i_k, r - r_k), t.dtype,
                                     t.device)
            u = torch.cat([u, pad], dim=1)
        factors.append(u)
    factors, fits = _cp_sweeps(t, factors, int(n_sweeps))
    # normalize in f64: push column norms into weights, sort descending
    norms = [torch.linalg.vector_norm(f, dim=0).double() for f in factors]
    weights = torch.ones((r,), dtype=torch.float64, device=t.device)
    for nvec in norms:
        weights = weights * nvec
    order = torch.argsort(-weights, stable=True)
    factors = [(f.double() / nv.clamp_min(1e-300)[None, :])[:, order]
               .to(t.dtype) for f, nv in zip(factors, norms)]
    return weights[order].to(t.dtype), factors, fits


def cp_reconstruct(weights, factors):
    """Dense tensor from a CP model: sum_r w_r outer(a_r^(1), ...).

    Accumulates one rank-one term at a time, so peak memory is the output
    plus one term, not the output times R (a (..., R) intermediate would be
    R times the output tensor)."""
    first = as_tensor(factors[0])
    cols = [first.mT] + [as_tensor(f, device=first.device).mT
                         for f in factors[1:]]          # each (R, I_k)
    w = as_tensor(weights, device=first.device)
    acc = first.new_zeros(tuple(int(c.shape[1]) for c in cols))
    for r in range(w.shape[0]):
        term = w[r] * cols[0][r]
        for c in cols[1:]:
            term = term[..., None] * c[r]
        acc += term
    return acc
