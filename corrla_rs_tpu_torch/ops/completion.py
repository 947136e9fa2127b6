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


def _normal_eqs(m_obs, mask, v):
    """The rowwise ridge-LS systems, unreduced: for every row i the flat
    sum_j mask_ij v_j v_j^T (n, r^2) and sum_j mask_ij m_ij v_j (n, r)."""
    r = v.shape[1]
    outer = (v[:, :, None] * v[:, None, :]).reshape(-1, r * r)
    return mask @ outer, m_obs @ v                         # mask pre-applied


def _solve_rows(g, b, lam_eye):
    """Solve every row's (G_i + lam I) u_i = b_i."""
    r = b.shape[1]
    return torch.linalg.solve(g.reshape(-1, r, r) + lam_eye,
                              b[:, :, None])[:, :, 0]


def _als_sweeps(m_obs, mask, v, lam, n_sweeps, psum=None):
    """The ALS sweeps from V. ``psum`` sums a tensor over the row shards
    when rows of ``m_obs``/``mask`` are sharded: the U update is row-local,
    the V update's systems and the residual are psummed (one (n, r^2 + r)
    block a sweep)."""
    psum = psum or (lambda t: t)
    n_obs = torch.clamp_min(psum(torch.sum(mask)), 1.0)
    lam_eye = lam * torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    m_obs_t, mask_t = m_obs.mT.contiguous(), mask.mT.contiguous()
    hist = m_obs.new_empty((n_sweeps,))
    u = m_obs.new_zeros((m_obs.shape[0], v.shape[1]))
    for i in range(n_sweeps):
        u = _solve_rows(*_normal_eqs(m_obs, mask, v), lam_eye)
        g, b = _normal_eqs(m_obs_t, mask_t, u)
        gb = psum(torch.cat([g, b], dim=1))
        v = _solve_rows(gb[:, :g.shape[1]], gb[:, g.shape[1]:], lam_eye)
        resid = m_obs - (u @ v.mT) * mask
        hist[i] = torch.sqrt(psum(torch.sum(resid * resid)) / n_obs)
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

    mesh: a DeviceMesh (``parallel.mesh.make_mesh``; every rank calls):
    rows of m/mask shard across its first axis (DTensors sharded so, or
    full arrays every rank holds; the rows must divide the axis size). The
    U update is row-local; the V update's per-column systems, the residual
    and the init's randomized SVD psum over the rows. m_hat and u come back
    as DTensors with ``Shard(0)``, v and the history replicated.

    Returns (m_hat, u, v, rmse_hist): the completed matrix U V^T, its
    factors, and the per-sweep observed-entry RMSE.
    """
    if mesh is not None:
        return _matrix_complete_sharded(m_data, mask, rank, n_sweeps, lam,
                                        key, mesh)
    m = as_tensor(m_data)
    msk = as_tensor(mask, device=m.device)
    m, msk, r = _checked(m, msk, rank, tuple(m.shape), tuple(msk.shape))
    # where(), not m * msk: NaN is the canonical missing-data marker and
    # NaN * 0 = NaN would poison everything downstream
    m_obs = torch.where(msk != 0, m, 0.0)
    lam_abs = _lam_abs(m_obs, msk, lam, lambda t: t)
    # spectral init: right singular subspace of the zero-filled matrix
    # (subspaces are scale-invariant, so no 1/p rescale is needed)
    _, _, vt = _rsvd.random_svd(m_obs, r, 6, 8, key=key)
    u, v, hist = _als_sweeps(m_obs, msk, vt.mT, lam_abs, int(n_sweeps))
    return u @ v.mT, u, v, hist


def _checked(m, msk, rank, shape, mask_shape):
    """(m as a float, the mask in m's dtype, the rank) after the checks of
    the global ``shape`` and ``mask_shape`` (of which m and msk may be one
    rank's rows)."""
    if len(shape) != 2:
        raise ValueError(f"m_data must be 2-d, got {len(shape)}-d")
    if not m.is_floating_point():
        # integer ratings are the canonical input; an int dtype would
        # int-cast the ridge to zero
        m = m.to(torch.float64)
    if mask_shape != shape:
        raise ValueError(
            f"mask shape {mask_shape} != data shape {shape}"
        )
    r = int(rank)
    if not 1 <= r <= min(shape):
        raise ValueError(f"rank must be in [1, min(m, n)], got {rank}")
    return m, msk.to(m.dtype), r


def _lam_abs(m_obs, msk, lam, psum) -> float:
    """The absolute ridge from the relative one: the observed mean square
    sets the scale so lam behaves the same across data magnitudes. One
    read: the observed count and the observed sum of squares."""
    n_obs, sum_sq = psum(torch.stack([torch.sum(msk),
                                      torch.sum(m_obs * m_obs)])).tolist()
    if n_obs == 0.0:
        raise ValueError("mask has no observed entries")
    return float(lam) * max(sum_sq / max(n_obs, 1.0), 1e-300)


def _matrix_complete_sharded(m_data, mask, rank, n_sweeps, lam, key, mesh):
    from corrla_rs_tpu_torch.parallel.mesh import _axis, _dtensor, _local, \
        _psum, _size
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import _svd_of_sharded

    axis = _axis(mesh, None)
    shape, mask_shape = tuple(m_data.shape), tuple(mask.shape)
    if len(shape) == 2 and shape[0] % _size(mesh, axis):
        raise ValueError(f"rows ({shape[0]}) must divide the mesh axis size "
                         f"({_size(mesh, axis)})")
    m_l, _ = _local(m_data, mesh, axis)
    msk_l = (_local(mask, mesh, axis, device=m_l.device)[0]
             if mask_shape == shape else None)
    m_l, msk_l, r = _checked(m_l, msk_l, rank, shape, mask_shape)

    def psum(t):
        return _psum(t, mesh, axis)

    m_obs = torch.where(msk_l != 0, m_l, 0.0)
    lam_abs = _lam_abs(m_obs, msk_l, lam, psum)
    _, _, vt = _svd_of_sharded(m_obs, shape, 0, r, 6, 8, key, mesh, axis)
    u, v, hist = _als_sweeps(m_obs, msk_l, vt.mT, lam_abs, int(n_sweeps),
                             psum)
    return (_dtensor(u @ v.mT, mesh, axis, 0, shape), _dtensor(
        u, mesh, axis, 0, (shape[0], r)), v, hist)
