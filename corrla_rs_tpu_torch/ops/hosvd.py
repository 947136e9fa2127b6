"""Truncated higher-order SVD / Tucker decomposition.

Counterpart of ``corrla_rs_tpu/ops/hosvd.py`` (no reference analogue: the
reference is strictly matrix-shaped). POD flattens multi-parameter snapshot
families into one matrix; this keeps the tensor structure: for a snapshot
tensor X (space x time x parameter x ...), the truncated HOSVD (De Lathauwer,
Moor & Vandewalle 2000) computes per-mode orthonormal bases U_k from the
mode-k unfoldings and a small core G = X x_0 U_0^T x_1 U_1^T ..., giving
X ~= G x_0 U_0 x_1 U_1 ... with multilinear ranks (r_0, r_1, ...). ``hooi``
refines the bases by alternating least squares (HOOI), which is optimal per
mode given the others.

Every unfolding SVD is this library's randomized SVD (the same sketch +
power-iteration core PCA/POD/DMD compose), each mode from its own child of
the seed, and mode products are single batched matrix products.
"""
from __future__ import annotations

import math

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["hosvd", "hooi", "tucker_reconstruct", "mode_multiply"]


def _check_ranks(ranks, tensor) -> tuple:
    ranks = tuple(int(r) for r in ranks)
    if len(ranks) != tensor.ndim:
        raise ValueError(
            f"ranks {ranks} must have one entry per tensor mode "
            f"({tensor.ndim})"
        )
    for k, (r, d) in enumerate(zip(ranks, tensor.shape)):
        if not 1 <= r <= d:
            raise ValueError(
                f"ranks[{k}]={r} must be in [1, {d}] (the mode-{k} "
                "dimension); the core is promised to have exactly the "
                "requested shape, so over-large ranks raise rather than "
                "silently clamp"
            )
    return ranks


def _unfold(t: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-k unfolding: (I_k, prod of the other dims)."""
    return torch.movedim(t, mode, 0).reshape(t.shape[mode], -1)


def mode_multiply(t: torch.Tensor, mat: torch.Tensor, mode: int) -> torch.Tensor:
    """Mode-k product t x_k mat: contracts t's mode-k axis with mat's
    SECOND axis (mat (J, I_k) maps axis size I_k -> J, staying at
    position ``mode``)."""
    moved = torch.movedim(t, mode, -1)
    return torch.movedim(moved @ mat.mT, -1, mode)


def _factor(unf: torch.Tensor, rank: int, n_iter: int, n_oversamples: int,
            key) -> torch.Tensor:
    r = min(rank, unf.shape[0])
    u, _s, _vt = _rsvd.random_svd(unf, r, n_iter, n_oversamples, key=key)
    return u


def _project(tensor, factors, skip=None):
    """tensor x_j U_j^T over every mode j but ``skip``."""
    out = tensor
    for j, u in enumerate(factors):
        if j != skip:
            out = mode_multiply(out, u.mT, j)
    return out


def hosvd(tensor: torch.Tensor, ranks: tuple, n_iter: int = 8,
          n_oversamples: int = 8, key=0):
    """Truncated HOSVD: ``(core, factors)`` with ``core`` of shape
    ``ranks`` and ``factors[k]`` (I_k, r_k) orthonormal (mode-k left
    singular vectors of the unfolding, via randomized SVD).

    Exact when the tensor has multilinear rank <= ranks; otherwise the
    error is within sqrt(ndim) of the best rank-(r_0,...) approximation
    (the classic HOSVD quasi-optimality bound); run ``hooi`` to tighten.
    """
    tensor = as_tensor(tensor)
    ranks = _check_ranks(ranks, tensor)
    keys = _rsvd._split_seed(key, tensor.ndim, tensor.device)
    factors = [
        _factor(_unfold(tensor, k), ranks[k], n_iter, n_oversamples,
                keys[k])
        for k in range(tensor.ndim)
    ]
    return _project(tensor, factors), factors


def hooi(tensor: torch.Tensor, ranks: tuple, n_sweeps: int = 3,
         n_iter: int = 8, n_oversamples: int = 8, key=0):
    """Higher-order orthogonal iteration (Tucker-ALS): HOSVD init, then
    ``n_sweeps`` rounds updating each factor from the tensor with all
    OTHER modes projected (so each unfolding SVD runs on a small
    (I_k, prod r_j) matrix: cheaper AND more accurate than HOSVD's full
    unfoldings). Returns ``(core, factors)`` like ``hosvd``."""
    tensor = as_tensor(tensor)
    ranks = _check_ranks(ranks, tensor)
    # the ALS update SVDs an (I_k, prod of the OTHER ranks) matrix, so a
    # mode rank above that product is structurally unreachable (any
    # multilinear rank satisfies r_k <= prod_{j != k} r_j): raise
    # instead of silently returning a smaller factor than requested
    for k, r in enumerate(ranks):
        other = math.prod(ranks[:k] + ranks[k + 1:])
        if r > other:
            raise ValueError(
                f"ranks[{k}]={r} exceeds prod(other ranks)={other}; every "
                "Tucker multilinear rank satisfies r_k <= prod of the "
                "others: lower it or raise the other ranks"
            )
    # fold before hosvd splits: a generator passed as ``key`` runs on
    folded = _rsvd._fold_seed(key, 1, tensor.device)
    _core, factors = hosvd(tensor, ranks, n_iter=n_iter,
                           n_oversamples=n_oversamples, key=key)
    keys = _rsvd._split_seed(folded, int(n_sweeps) * tensor.ndim,
                             tensor.device)
    ki = 0
    for _sweep in range(int(n_sweeps)):
        for k in range(tensor.ndim):
            proj = _project(tensor, factors, skip=k)
            factors[k] = _factor(
                _unfold(proj, k), ranks[k], n_iter, n_oversamples, keys[ki]
            )
            ki += 1
    return _project(tensor, factors), factors


def tucker_reconstruct(core: torch.Tensor, factors) -> torch.Tensor:
    """X_hat = core x_0 U_0 x_1 U_1 ...: inverse of the compression."""
    out = core
    for k, u in enumerate(factors):
        out = mode_multiply(out, u, k)
    return out
