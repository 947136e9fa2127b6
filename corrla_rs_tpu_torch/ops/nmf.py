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


def _nmf_sweeps(x, w, h, n_sweeps):
    eps = torch.finfo(x.dtype).eps
    x_norm = torch.linalg.matrix_norm(x)
    errs = x.new_empty((n_sweeps,))
    for i in range(n_sweeps):
        w = _hals_half(w, x @ h.mT, h @ h.mT, eps)
        h = _hals_half(h.mT, x.mT @ w, w.mT @ w, eps).mT
        errs[i] = torch.linalg.matrix_norm(x - w @ h) / torch.clamp_min(
            x_norm, eps)
    return w, h, errs


def _nndsvd(u, s, vt, fill):
    """NNDSVD-a start (W0 (m, r), H0 (r, n)) in f64 from the leading
    singular triplets: the first pair by absolute value, every other from
    the dominant of its positive and negative parts; exact zeros (which
    lock a HALS column: max(0, .) can never reactivate a dead component)
    are filled with ``fill``, the data mean, as sklearn does."""
    u, s, v = u.double(), s.double(), vt.double().mT
    up, un = torch.clamp_min(u, 0.0), torch.clamp_min(-u, 0.0)
    vp, vn = torch.clamp_min(v, 0.0), torch.clamp_min(-v, 0.0)
    nup, nun = (torch.linalg.vector_norm(t, dim=0) for t in (up, un))
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

    mesh: the JAX package's row sharding, not ported (anything but None
    raises).
    """
    if mesh is not None:
        raise NotImplementedError("nmf(mesh=...) is not ported")
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
