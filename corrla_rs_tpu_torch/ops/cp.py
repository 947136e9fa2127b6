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

import math

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


def _cp_sweeps(t, factors, n_sweeps, psum=None):
    """The ALS sweeps. ``psum`` sums a tensor over the shards when mode 0
    of ``t`` (and the rows of factor 0) are sharded: mode 0's MTTKRP stays
    local, every other mode's contracts the sharded axis and is psummed (an
    (I_k, R) block an update), as are factor 0's Gram and ||T||^2."""
    psum = psum or (lambda x: x)
    d = t.ndim
    eps = torch.finfo(t.dtype).eps
    t_norm2 = psum(torch.sum(t * t))
    eye = torch.eye(factors[0].shape[1], dtype=t.dtype, device=t.device)
    factors = list(factors)
    grams = [f.mT @ f for f in factors]
    grams[0] = psum(grams[0])
    fits = t.new_empty((n_sweeps,))
    for i in range(n_sweeps):
        for mode in range(d):
            g = _hadamard_gram(grams, skip=mode)
            m = _mttkrp(t, factors, mode)            # (I_mode, R)
            if mode:
                m = psum(m)
            # ridge well above roundoff: over-ranked fits drive factor
            # columns collinear and make the Hadamard Gram numerically
            # singular; an eps-scale ridge lets the solve emit NaN
            reg = 100.0 * eps * torch.trace(g) / g.shape[0] + eps
            factors[mode] = torch.linalg.solve(g + reg * eye, m.mT).mT
            grams[mode] = factors[mode].mT @ factors[mode]
            if not mode:
                grams[0] = psum(grams[0])
        # fit = 1 - ||T - That|| / ||T|| via the inner-product identity
        inner = torch.sum(psum(_mttkrp(t, factors, d - 1)) * factors[d - 1])
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

    mesh: a DeviceMesh (``parallel.mesh.make_mesh``; every rank calls):
    mode 0 of the tensor (the tall snapshot/sample mode) shards across its
    first axis (a DTensor sharded so, or the full tensor every rank holds;
    I_0 must divide the axis size), and factor 0 comes back a DTensor with
    ``Shard(0)``. The init's randomized SVDs factor each unfolding on the
    shards (mode 0's unfolding row-sharded, every other one column-
    sharded); every other mode's MTTKRP is psummed once an update.

    Returns (weights, factors, fits): ``weights`` (R,) positive scales
    (factors column-normalized, largest component first), ``factors`` a
    list of (I_k, R) matrices, ``fits`` (n_sweeps,) the fit history
    1 - ||T - T_hat||/||T|| (monotone up to roundoff; inspect it to judge
    convergence). Reconstruction via :func:`cp_reconstruct`.
    """
    if mesh is not None:
        return _cp_als_sharded(tensor, rank, n_sweeps, key, init, mesh)
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
    factors = _cp_init(t, tuple(t.shape), r, key, init,
                       lambda _k, unf, r_k, n_os, key: _rsvd.random_svd(
                           unf, r_k, 4, n_os, key=key)[0])
    factors, fits = _cp_sweeps(t, factors, int(n_sweeps))
    weights, factors = _cp_normalize(factors, r)
    return weights, factors, fits


def _cp_init(t, shape, r, key, init, svd, rows=(0, None)):
    """The start factors of the tensor of global ``shape`` (``t``, or this
    rank's block of mode 0 at offset ``rows[0]`` of length ``rows[1]``):
    random, or each unfolding's leading left singular vectors, ``svd(mode,
    unfolding, rank, n_oversamples, key)`` (4 power iterations), padded with
    random columns for narrow modes. Mode 0's random rows are drawn whole
    and cut to the block."""
    keys = _rsvd._split_seed(key, len(shape), t.device)
    lo, n_l = rows
    factors = []
    for k, i_k in enumerate(shape):
        cut = slice(lo, lo + n_l) if (k == 0 and n_l is not None) \
            else slice(None)
        if init == "random":
            factors.append(_rsvd._draw_sketch(keys[k], (i_k, r), t.dtype,
                                              t.device)[cut])
            continue
        unf = torch.movedim(t, k, 0).reshape(t.shape[k], -1)
        r_k = min(r, i_k, math.prod(shape) // i_k)
        # the fold comes first: drawing from keys[k] would advance it
        pad_key = _rsvd._fold_seed(keys[k], 1, t.device) if r_k < r else None
        u = svd(k, unf, r_k, min(8, i_k), keys[k])
        if r_k < r:  # pad narrow modes with random columns
            pad = _rsvd._draw_sketch(pad_key, (i_k, r - r_k), t.dtype,
                                     t.device)[cut]
            u = torch.cat([u, pad], dim=1)
        factors.append(u)
    return factors


def _cp_normalize(factors, r, psum=None):
    """(weights, factors) in f64: the column norms pushed into the weights
    (with ``psum``, factor 0's over its row shards), sorted descending."""
    norms = [torch.linalg.vector_norm(f, dim=0).double() for f in factors]
    if psum is not None:
        norms[0] = torch.sqrt(psum(torch.sum(factors[0].double() ** 2,
                                             dim=0)))
    weights = torch.ones((r,), dtype=torch.float64, device=factors[0].device)
    for nvec in norms:
        weights = weights * nvec
    order = torch.argsort(-weights, stable=True)
    dt = factors[0].dtype
    factors = [(f.double() / nv.clamp_min(1e-300)[None, :])[:, order]
               .to(dt) for f, nv in zip(factors, norms)]
    return weights[order].to(dt), factors


def _cp_als_sharded(tensor, rank, n_sweeps, key, init, mesh):
    from corrla_rs_tpu_torch.parallel.mesh import _axis, _coord, _dtensor, \
        _local, _psum, _size
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import _svd_of_sharded

    axis = _axis(mesh, None)
    shape = tuple(int(v) for v in tensor.shape)
    if len(shape) < 2:
        raise ValueError(f"tensor must be >= 2-way, got {len(shape)}-way")
    r = int(rank)
    if r < 1:
        raise ValueError(f"rank must be >= 1, got {rank}")
    if init not in ("svd", "random"):
        raise ValueError(f"init must be 'svd' or 'random', got {init!r}")
    n_dev = _size(mesh, axis)
    if shape[0] % n_dev:
        raise ValueError(f"rows ({shape[0]}) must divide the mesh axis size "
                         f"({n_dev})")
    t_l, _ = _local(tensor, mesh, axis)

    def psum(x):
        return _psum(x, mesh, axis)

    def svd(k, unf, r_k, n_os, key):
        # mode 0's unfolding is row-sharded, every other one's columns
        # (the blocks of I_0 come slowest in its flattening)
        full = (shape[0], unf.shape[1]) if k == 0 \
            else (unf.shape[0], unf.shape[1] * n_dev)
        return _svd_of_sharded(unf, full, min(k, 1), r_k, 4, n_os, key,
                               mesh, axis)[0]

    if not bool(psum(torch.any(t_l != 0).to(t_l.dtype)) > 0):
        zeros = [t_l.new_zeros((shape[k] if k else t_l.shape[0], r))
                 for k in range(len(shape))]
        zeros[0] = _dtensor(zeros[0], mesh, axis, 0, (shape[0], r))
        return t_l.new_zeros((r,)), zeros, t_l.new_ones((int(n_sweeps),))
    n_l = t_l.shape[0]
    factors = _cp_init(t_l, shape, r, key, init, svd,
                       rows=(_coord(mesh, axis) * n_l, n_l))
    factors, fits = _cp_sweeps(t_l, factors, int(n_sweeps), psum)
    weights, factors = _cp_normalize(factors, r, psum)
    factors[0] = _dtensor(factors[0], mesh, axis, 0, (shape[0], r))
    return weights, factors, fits


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
