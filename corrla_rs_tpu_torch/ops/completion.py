"""Low-rank matrix completion by alternating least squares.

Counterpart of ``corrla_rs_tpu/ops/completion.py`` (no reference analogue;
the classic collaborative-filtering / missing-data recovery problem, cf.
Koren-Bell-Volinsky 2009 and the nuclear-norm recovery theory of
Candes-Recht 2009).

Given a partially observed matrix (a mask of known entries), fit
M ~= U V^T of rank r by minimizing the squared error on the OBSERVED entries
plus a ridge: the alternating updates are exact row-wise least squares, each
sweep a pair of closed-form batched solves.

The per-row normal equations of ALL rows are built in one product each:
G (n_rows, r, r) = sum_j mask_ij v_j v_j^T is the mask times the (n_cols,
r^2) table of outer products, and the right-hand sides are one masked
product; then one batched ``torch.linalg.solve``. No gather or scatter over
the observed set and no sparse format: the mask rides as a dense 0/1 matrix.
A fixed number of sweeps runs in a host loop that reads nothing from the
device, with an observed-entry RMSE history.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["matrix_complete"]


def _solve_side(m_obs, mask, v, lam_eye):
    """Rowwise ridge LS: for every row i solve
    (sum_j mask_ij v_j v_j^T + lam I) u_i = sum_j mask_ij m_ij v_j."""
    r = v.shape[1]
    outer = (v[:, :, None] * v[:, None, :]).reshape(-1, r * r)
    g = (mask @ outer).reshape(-1, r, r) + lam_eye         # (n, r, r)
    b = m_obs @ v                                          # mask pre-applied
    return torch.linalg.solve(g, b[:, :, None])[:, :, 0]


def _als_sweeps(m_obs, mask, v, lam, n_sweeps):
    n_obs = torch.clamp_min(torch.sum(mask), 1.0)
    lam_eye = lam * torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    m_obs_t, mask_t = m_obs.mT.contiguous(), mask.mT.contiguous()
    hist = m_obs.new_empty((n_sweeps,))
    u = m_obs.new_zeros((m_obs.shape[0], v.shape[1]))
    for i in range(n_sweeps):
        u = _solve_side(m_obs, mask, v, lam_eye)
        v = _solve_side(m_obs_t, mask_t, u, lam_eye)
        resid = m_obs - (u @ v.mT) * mask
        hist[i] = torch.sqrt(torch.sum(resid * resid) / n_obs)
    return u, v, hist


def matrix_complete(m_data, mask, rank: int, n_sweeps: int = 30,
                    lam: float = 1e-6, key=0, mesh=None):
    """Complete a partially observed matrix at the given rank.

    m_data: (m, n) with arbitrary values at UNOBSERVED positions (they are
    ignored); mask: (m, n) boolean/0-1 of observed entries; rank: model
    rank r; lam: ridge (relative to the observed scale: scaled internally
    by the observed mean square); n_sweeps: ALS sweeps (convergence is fast;
    inspect the returned history); key: int seed or ``torch.Generator`` of
    the spectral init's sketch.

    mesh: the JAX package's row sharding, not ported (anything but None
    raises).

    Returns (m_hat, u, v, rmse_hist): the completed matrix U V^T, its
    factors, and the per-sweep observed-entry RMSE.
    """
    if mesh is not None:
        raise NotImplementedError("matrix_complete(mesh=...) is not ported")
    m = as_tensor(m_data)
    if m.ndim != 2:
        raise ValueError(f"m_data must be 2-d, got {m.ndim}-d")
    if not m.is_floating_point():
        # integer ratings are the canonical input; an int dtype would
        # int-cast the ridge to zero
        m = m.to(torch.float64)
    msk = as_tensor(mask, device=m.device)
    if msk.shape != m.shape:
        raise ValueError(
            f"mask shape {tuple(msk.shape)} != data shape {tuple(m.shape)}"
        )
    r = int(rank)
    if not 1 <= r <= min(m.shape):
        raise ValueError(f"rank must be in [1, min(m, n)], got {rank}")
    msk = msk.to(m.dtype)
    # where(), not m * msk: NaN is the canonical missing-data marker and
    # NaN * 0 = NaN would poison everything downstream
    m_obs = torch.where(msk != 0, m, 0.0)
    # one read: the observed count and the observed sum of squares
    n_obs, sum_sq = torch.stack([torch.sum(msk),
                                 torch.sum(m_obs * m_obs)]).tolist()
    if n_obs == 0.0:
        raise ValueError("mask has no observed entries")
    # absolute ridge from the relative one: the observed mean square sets
    # the scale so lam behaves the same across data magnitudes
    lam_abs = float(lam) * max(sum_sq / max(n_obs, 1.0), 1e-300)
    # spectral init: right singular subspace of the zero-filled matrix
    # (subspaces are scale-invariant, so no 1/p rescale is needed)
    _, _, vt = _rsvd.random_svd(m_obs, r, 6, 8, key=key)
    u, v, hist = _als_sweeps(m_obs, msk, vt.mT, lam_abs, int(n_sweeps))
    return u @ v.mT, u, v, hist
