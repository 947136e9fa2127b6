"""Interpolative and CUR (skeleton) decompositions.

Counterpart of ``corrla_rs_tpu/ops/id_cur.py`` (beyond the reference, which
has no ID/CUR). Low-rank factorizations whose factors are actual
rows/columns of A:

    column ID :  A ~= A[:, J] @ X          X (k, n), X[:, J] = I_k
    row ID    :  A ~= Z @ A[I, :]          Z (m, k), Z[I, :] = I_k
    CUR       :  A ~= A[:, J] @ U @ A[I, :]

Unlike the SVD's abstract singular vectors, the skeleton columns/rows ARE
data: representative snapshots, sensor locations, landmark points.

Algorithm (Liberty et al. 2007 / Voronin & Martinsson 2017): compress A to
B = Q^T A (l, n) with the randomized range finder already used by random_svd
(ops/random_svd.power_iter, parity random_svd.rs:15-59), then run greedy
column-pivoted QR on the small B to pick the k pivot columns and form the
interpolation matrix X = R11^{-1} R by one triangular solve.

The QRCP is a host loop over k rank-1 Gram-Schmidt downdates of the (l, n)
panel. Each step's pivot stays on the device (an ``argmax`` that indexes the
panel as a tensor), so the loop reads nothing back; the heavy lifting
(sketch, B = Q^T A) is matrix products. Selection quality therefore matches
QRCP on the l-dimensional compression of A, the standard randomized-ID
choice. Indices come back as int64, torch's index type.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["column_id", "row_id", "cur"]


def _qrcp(b: torch.Tensor, k: int):
    """Greedy column-pivoted QR of ``b`` (l, n): k pivots + R (k, n).

    Step j picks the column of the residual panel with the largest norm,
    normalizes it into q_j, and rank-1-downdates the panel. R rows are
    q_j^T applied to the pre-downdate panel, so R[:, pivots] is upper
    triangular (residuals of already-chosen columns are exactly the
    downdated zeros). Selected columns are masked out of the argmax so
    fp dust never re-selects one.
    """
    _l, n = b.shape
    tiny = torch.finfo(b.dtype).tiny ** 0.5
    w = b
    r = b.new_zeros((k, n))
    piv = torch.zeros((k,), dtype=torch.int64, device=b.device)
    sel = torch.zeros((n,), dtype=torch.bool, device=b.device)
    for j in range(k):
        norms = torch.sum(w * w, dim=0).masked_fill(sel, -1.0)
        p = torch.argmax(norms).reshape(1)
        col = w.index_select(1, p)[:, 0]
        q = col / torch.linalg.vector_norm(col).clamp_min(tiny)
        rrow = q @ w
        w = w - q[:, None] * rrow[None, :]
        r[j] = rrow
        piv[j:j + 1] = p
        sel = sel.index_fill(0, p, True)
    return piv, r


def _interp_from_r(r: torch.Tensor, piv: torch.Tensor) -> torch.Tensor:
    """X = R11^{-1} R with R11 = R[:, piv] (upper triangular by
    construction). Tiny diagonals (rank < k requested) are clamped to
    eps * max|diag| so the solve stays finite: the corresponding
    interpolation rows are then ~arbitrary but bounded, matching LAPACK
    xGEQP3-based ID behavior past the numerical rank."""
    k = r.shape[0]
    r11 = r.index_select(1, piv)
    d = torch.diagonal(r11)
    floor = torch.finfo(r.dtype).eps * d.abs().max().clamp_min(1.0)
    d_safe = torch.where(d.abs() < floor, floor.expand_as(d), d)
    r11 = r11 - torch.diag(d) + torch.diag(d_safe)
    x = torch.linalg.solve_triangular(r11, r, upper=True)
    # exactness at the skeleton: X[:, piv] = I by construction up to the
    # solve's rounding; pin it
    return x.index_copy(1, piv, torch.eye(k, dtype=r.dtype, device=r.device))


def column_id(a, rank: int, n_iter: int = 2, n_oversamples: int = 8,
              key=0):
    """Randomized column interpolative decomposition.

    Returns ``(cols (rank,) int64, x (rank, n))`` with
    ``a ~= a[:, cols] @ x`` and ``x[:, cols] == I``. Error tracks the
    rank-``rank`` SVD error times a modest pivoting factor.

    Parameters mirror ``random_svd``: ``n_iter`` power iterations sharpen
    the range estimate (0 = plain one-sketch ID), ``n_oversamples`` pads
    the sketch. ``a`` may be wider or taller than square; dtype is
    preserved.
    """
    a = as_tensor(a)
    m, n = a.shape
    if not 1 <= rank <= min(m, n):
        raise ValueError(
            f"rank must be in [1, min(m, n)] = [1, {min(m, n)}], "
            f"got {rank}"
        )
    l = min(rank + int(n_oversamples), min(m, n))
    q = _rsvd.power_iter(a, l, int(n_iter), key=key)
    piv, r = _qrcp(q.mT @ a, rank)                  # (l, n) compression
    return piv, _interp_from_r(r, piv)


def row_id(a, rank: int, n_iter: int = 2, n_oversamples: int = 8, key=0):
    """Randomized row interpolative decomposition.

    Returns ``(rows (rank,) int64, z (m, rank))`` with
    ``a ~= z @ a[rows, :]`` and ``z[rows, :] == I``: the transpose of
    :func:`column_id`.
    """
    piv, x = column_id(as_tensor(a).mT, rank, n_iter=n_iter,
                       n_oversamples=n_oversamples, key=key)
    return piv, x.mT


def cur(a, rank: int, n_iter: int = 2, n_oversamples: int = 8, key=0,
        method: str = "stable"):
    """Randomized CUR: ``a ~= a[:, cols] @ u @ a[rows, :]``.

    Returns ``(rows (rank,), cols (rank,), u (rank, rank))``. Rows and
    columns are selected by independent row/column IDs (fresh child
    seeds); ``method`` picks how U is formed:

    - ``'stable'`` (default): U = C^+ A R^+ via two least-squares solves,
      the optimal core for the chosen skeletons, robust to noise
      (Mahoney & Drineas 2009 semantics).
    - ``'skeleton'``: U = A[rows, cols]^{-1} (classical cross /
      Goreinov skeleton): exact when rank(A) = rank and the
      intersection block is nonsingular, cheapest, but noise in the
      k x k block propagates unchecked.
    """
    if method not in ("stable", "skeleton"):
        raise ValueError(
            f"method must be 'stable' or 'skeleton', got {method!r}"
        )
    a = as_tensor(a)
    k_col, k_row = _rsvd._split_seed(key, 2, a.device)
    cols, _ = column_id(a, rank, n_iter=n_iter,
                        n_oversamples=n_oversamples, key=k_col)
    rows, _ = row_id(a, rank, n_iter=n_iter,
                     n_oversamples=n_oversamples, key=k_row)
    c = a.index_select(1, cols)
    r = a.index_select(0, rows)
    if method == "skeleton":
        u = torch.linalg.inv(c.index_select(0, rows))
    else:
        # U = pinv(C) A pinv(R) without forming pinvs: two lstsq solves
        ca = torch.linalg.lstsq(c, a).solution        # (k, n) = C^+ A
        u = torch.linalg.lstsq(r.mT, ca.mT).solution.mT   # (C^+ A) R^+
    return rows, cols, u
