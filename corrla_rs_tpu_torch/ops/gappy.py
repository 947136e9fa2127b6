"""Gappy POD: field reconstruction from sparse point sensors, and iterative
repair of gappy snapshot data.

Counterpart of ``corrla_rs_tpu/ops/gappy.py`` (Everson & Sirovich 1995;
Bui-Thanh, Damodaran & Willcox 2004):

1. ``gappy_reconstruct``: x_hat = U c with c = argmin ||x_obs - U_obs c||^2
   from s >= r sensor rows (QR least squares, or a ridge-regularised r x r
   Gram solve); several snapshots are one batched product;
2. ``gappy_pod_fill``: alternate [POD of the current fill -> re-estimate
   the missing entries from the gappy projection] for a fixed number of
   sweeps, each a step of device work with nothing read back;
3. ``oversample_points``: extend a sensor set greedily by the row that most
   reduces the pseudo-inverse amplification (rank-one Sherman-Morrison
   updates of (U_obs^T U_obs)^{-1}), a loop that reads nothing back inside
   a step.

The per-snapshot gappy Grams (U^T M_j U, one a snapshot) are one product of
the mask with the (n, r^2) row-wise outer products of U, where the JAX
package writes them as one einsum.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["gappy_reconstruct", "gappy_pod_fill", "oversample_points"]


def gappy_reconstruct(modes, points, values, ridge: float = 0.0):
    """Reconstruct full fields from values at ``points`` rows.

    modes: (n, r) mode matrix; points: (s,) int sensor rows, s >= r;
    values: (s,) or (s, m) measured values at those rows; ridge: optional
    Tikhonov weight on the coefficient norm.

    Returns ``(x_hat, coeffs)``: the reconstructed field(s) (n,)/(n, m) and
    the gappy POD coefficients (r,)/(r, m); ``x_hat`` is exact for any field
    in span(modes) when ridge == 0 and U_obs has full column rank.
    """
    modes = as_tensor(modes)
    points = as_tensor(points, device=modes.device).long()
    values = as_tensor(values, device=modes.device, dtype=modes.dtype)
    u_obs = modes[points]                          # (s, r)
    vec = values.ndim == 1
    b = values[:, None] if vec else values         # (s, m)
    if ridge > 0.0:
        r = modes.shape[1]
        g = u_obs.mT @ u_obs + ridge * torch.eye(r, dtype=modes.dtype,
                                                 device=modes.device)
        coeffs = torch.linalg.solve(g, u_obs.mT @ b)
    else:
        # QR least squares: stable for oversampled sensor sets without
        # squaring the condition number
        q, rr = torch.linalg.qr(u_obs)
        coeffs = torch.linalg.solve_triangular(rr, q.mT @ b, upper=True)
    x_hat = modes @ coeffs
    if vec:
        return x_hat[:, 0], coeffs[:, 0]
    return x_hat, coeffs


def gappy_pod_fill(snapshots, mask, rank: int, n_sweeps: int = 25,
                   device=None):
    """Repair a gappy snapshot matrix by iterated gappy-POD projection.

    snapshots: (n, m) data, entries where ``mask`` is False ignored; mask:
    (n, m) bool, True = observed; rank: POD rank of the repair subspace;
    n_sweeps: fixed sweep count. ``device`` is where numpy input goes.

    Returns ``(filled, modes, sigma)``: the repaired matrix (observed
    entries kept verbatim), the final (n, rank) POD modes of the repaired
    data, and their singular values.
    """
    snapshots = as_tensor(snapshots, device=device)
    mask = as_tensor(mask, device=snapshots.device).bool()
    mask_f = mask.to(snapshots.dtype)
    x_obs = torch.where(mask, snapshots, 0.0)
    n, m = snapshots.shape
    # init: missing entries get their row's observed mean (a row with
    # nothing observed gets 0)
    cnt = torch.clamp_min(mask_f.sum(dim=1, keepdim=True), 1.0)
    row_mean = x_obs.sum(dim=1, keepdim=True) / cnt
    x = torch.where(mask, snapshots, row_mean.expand(n, m))
    eye = torch.eye(rank, dtype=x.dtype, device=x.device)
    for _ in range(int(n_sweeps)):
        u = torch.linalg.svd(x, full_matrices=False)[0]
        ur = u[:, :rank]                           # (n, r)
        # per-snapshot gappy LS in the current basis: for column j,
        # (U^T M_j U) c = U^T M_j x_j, all columns in one batched solve
        outer = (ur[:, :, None] * ur[:, None, :]).reshape(n, rank * rank)
        g = (mask_f.mT @ outer).reshape(m, rank, rank) + 1e-10 * eye
        rhs = x_obs.mT @ ur                        # (m, r)
        c = torch.linalg.solve(g, rhs[..., None])[..., 0]
        x = torch.where(mask, snapshots, ur @ c.mT)
    u, s, _vt = torch.linalg.svd(x, full_matrices=False)
    return x, u[:, :rank], s[:rank]


def oversample_points(modes, points, n_extra: int):
    """Greedily append ``n_extra`` sensor rows to an existing selection.

    Each step adds the row u with the largest gain u^T (U_s^T U_s)^{-1} u,
    the row whose inclusion most raises the log-determinant of the sensor
    Gram, and updates the inverse by Sherman-Morrison. Rows already
    selected are masked out. Returns the extended (len(points) + n_extra,)
    int64 index vector.
    """
    modes = as_tensor(modes)
    points = as_tensor(points, device=modes.device).long()
    n, r = modes.shape
    s0 = points.shape[0]
    total = s0 + int(n_extra)
    sel = torch.full((total,), -1, dtype=torch.int64, device=modes.device)
    sel[:s0] = points
    u0 = modes[points]                             # (s0, r)
    g = u0.mT @ u0 + 1e-12 * torch.eye(r, dtype=modes.dtype,
                                       device=modes.device)
    ginv = torch.linalg.inv(g)
    taken = torch.zeros(n, dtype=torch.bool, device=modes.device)
    taken[points] = True
    for j in range(s0, total):
        gain = torch.sum((modes @ ginv) * modes, dim=1)
        gain = torch.where(taken, -torch.inf, gain)
        p = torch.argmax(gain)
        u = modes[p]
        gu_p = ginv @ u[:, None]                   # (r, 1)
        denom = 1.0 + u @ gu_p[:, 0]
        ginv = ginv - (gu_p @ gu_p.mT) / denom
        sel[j] = p
        taken[p] = True
    return sel
