"""Nonnegative matrix factorization (HALS).

Counterpart of ``corrla_rs_tpu/ops/nmf.py`` (no reference analogue; it
completes the constrained-factorization family next to ``robust_pca`` and
the CP/Tucker/TT tensor models).

X ~= W H with W, H >= 0: the parts-based decomposition (topics, spectra,
counts) that unconstrained SVD factors cannot give. The solver is HALS
(hierarchical alternating least squares, Cichocki-Phan 2009): per-component
closed-form updates, with far faster convergence than multiplicative
updates. The init is NNDSVD (Boutsidis-Gallopoulos 2008): deterministic,
from the randomized SVD's sign-split factors.

Each sweep forms the two Gram pairs (X H^T, H H^T) and (W^T X, W^T W) with
dense products; the per-component HALS updates are a rank-length loop of
rank-1 corrections. A fixed number of sweeps runs in a host loop that reads
nothing from the device; the error history is one device tensor.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["nmf"]


def _hals_half(w, xh, hh, eps):
    """One HALS pass over W's columns given XH = X H^T, HH = H H^T. The
    division guard ``eps`` meets HH in the data's dtype."""
    w = w.clone()
    for j in range(w.shape[1]):
        grad_j = xh[:, j] - w @ hh[:, j]
        w[:, j] = torch.clamp_min(
            w[:, j] + grad_j / torch.clamp_min(hh[j, j], eps), 0.0)
    return w


def _nmf_sweeps(x, w, h, n_sweeps, psum=None):
    """The HALS sweeps. ``psum`` sums a tensor over the row shards when X
    and W are row-sharded: the W half is local, the H half's Grams (W^T X,
    W^T W) are one (r, n + r) psum a sweep, and so is the error's square."""
    eps = torch.finfo(x.dtype).eps
    if psum is None:
        x_norm = torch.linalg.matrix_norm(x)
    else:
        x_norm = torch.sqrt(psum(torch.sum(x * x)))
    errs = x.new_empty((n_sweeps,))
    for i in range(n_sweeps):
        w = _hals_half(w, x @ h.mT, h @ h.mT, eps)
        if psum is None:
            h = _hals_half(h.mT, x.mT @ w, w.mT @ w, eps).mT
            err = torch.linalg.matrix_norm(x - w @ h)
        else:
            wx_ww = psum(w.mT @ torch.cat([x, w], dim=1))     # (r, n + r)
            n = x.shape[1]
            h = _hals_half(h.mT, wx_ww[:, :n].mT, wx_ww[:, n:], eps).mT
            resid = x - w @ h
            err = torch.sqrt(psum(torch.sum(resid * resid)))
        errs[i] = err / torch.clamp_min(x_norm, eps)
    return w, h, errs


def _nndsvd(u, s, vt, fill, psum=None):
    """NNDSVD-a start (W0 (m, r), H0 (r, n)) in f64 from the leading
    singular triplets: the first pair by absolute value, every other from
    the dominant of its positive and negative parts; exact zeros (which
    lock a HALS column: max(0, .) can never reactivate a dead component)
    are filled with ``fill``, the data mean, as sklearn does. ``psum``
    sums over the row shards when ``u`` is this rank's rows."""
    u, s, v = u.double(), s.double(), vt.double().mT
    up, un = torch.clamp_min(u, 0.0), torch.clamp_min(-u, 0.0)
    vp, vn = torch.clamp_min(v, 0.0), torch.clamp_min(-v, 0.0)
    if psum is None:
        nup, nun = (torch.linalg.vector_norm(t, dim=0) for t in (up, un))
    else:
        nup, nun = torch.sqrt(psum(torch.stack(
            [torch.sum(up * up, dim=0), torch.sum(un * un, dim=0)])))
    nvp, nvn = (torch.linalg.vector_norm(t, dim=0) for t in (vp, vn))
    pos = (nup * nvp >= nun * nvn)[None, :]
    scale = torch.sqrt(s * torch.where(pos[0], nup * nvp, nun * nvn))[None, :]
    w0 = scale * torch.where(pos, up / nup.clamp_min(1e-300),
                             un / nun.clamp_min(1e-300))
    h0 = scale * torch.where(pos, vp / nvp.clamp_min(1e-300),
                             vn / nvn.clamp_min(1e-300))
    w0[:, 0] = torch.sqrt(s[0]) * u[:, 0].abs()
    h0[:, 0] = torch.sqrt(s[0]) * v[:, 0].abs()
    w0 = torch.where(w0 == 0, fill, w0)
    h0 = torch.where(h0 == 0, fill, h0)
    return w0, h0.mT


def nmf(x_data, rank: int, n_sweeps: int = 200, key=0, mesh=None):
    """Nonnegative factorization X ~= W H (W (m, r), H (r, n) >= 0).

    Returns (w, h, rel_errs) with rel_errs the per-sweep relative Frobenius
    reconstruction error (non-increasing up to roundoff). ``key`` is an int
    seed or a ``torch.Generator`` (the sketch of the init's randomized SVD).

    mesh: a DeviceMesh (``parallel.mesh.make_mesh``; every rank calls): X
    and W shard along the tall m axis over its first axis (X a DTensor
    sharded so, or the full matrix every rank holds; m must divide the
    axis size), H is replicated; W comes back a DTensor with ``Shard(0)``.
    The init's randomized SVD runs on the shards, and each sweep psums the
    H half's Grams once.
    """
    if mesh is not None:
        return _nmf_sharded(x_data, rank, n_sweeps, key, mesh)
    x = as_tensor(x_data)
    if x.ndim != 2:
        raise ValueError(f"x_data must be 2-d, got {x.ndim}-d")
    if bool(torch.any(x < 0)):
        raise ValueError("x_data must be nonnegative")
    r = int(rank)
    if not 1 <= r <= min(x.shape):
        raise ValueError(
            f"rank must be in [1, min(m, n)], got {rank}"
        )
    u, s, vt = _rsvd.random_svd(x, r, 6, min(8, int(min(x.shape))), key=key)
    w0, h0 = _nndsvd(u, s, vt, torch.mean(x).double())
    return _nmf_sweeps(x, w0.to(x.dtype), h0.to(x.dtype), int(n_sweeps))


def _nmf_sharded(x_data, rank, n_sweeps, key, mesh):
    from corrla_rs_tpu_torch.parallel.mesh import _axis, _dtensor, _local, \
        _psum, _size
    from corrla_rs_tpu_torch.parallel.sharded_rsvd import _svd_of_sharded

    axis = _axis(mesh, None)
    shape = tuple(int(v) for v in x_data.shape)
    if len(shape) != 2:
        raise ValueError(f"x_data must be 2-d, got {len(shape)}-d")
    if shape[0] % _size(mesh, axis):
        raise ValueError(f"rows ({shape[0]}) must divide the mesh axis size "
                         f"({_size(mesh, axis)})")
    x, _ = _local(x_data, mesh, axis)

    def psum(t):
        return _psum(t, mesh, axis)

    # one read: any negative entry and the sum (for the fill)
    n_neg, total = psum(torch.stack([torch.sum(x < 0).to(x.dtype),
                                     torch.sum(x)])).tolist()
    if n_neg:
        raise ValueError("x_data must be nonnegative")
    r = int(rank)
    if not 1 <= r <= min(shape):
        raise ValueError(
            f"rank must be in [1, min(m, n)], got {rank}"
        )
    u, s, vt = _svd_of_sharded(x, shape, 0, r, 6, min(8, min(shape)), key,
                               mesh, axis)
    fill = torch.tensor(total / (shape[0] * shape[1]), dtype=torch.float64,
                        device=x.device)
    w0, h0 = _nndsvd(u, s, vt, fill, psum)
    w, h, errs = _nmf_sweeps(x, w0.to(x.dtype), h0.to(x.dtype),
                             int(n_sweeps), psum)
    return _dtensor(w, mesh, axis, 0, (shape[0], r)), h, errs
