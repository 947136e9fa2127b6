"""Sketch-and-precondition least squares.

Counterpart of ``corrla_rs_tpu/ops/sketch_solve.py`` (no reference analogue;
Blendenpik: Avron-Maymounkov-Toledo 2010, LSRN: Meng-Saunders-Mahoney 2014).

For very tall systems (m >> n: RBF weight solves over long sample axes,
regression on streamed features) the randomized recipe beats dense QR/pinv
at O(m n^2): ONE sketch product S A (the only O(m n s) work), a QR of the
small (s, n) sketch, and a short preconditioned CGLS loop whose iterates each
cost two more tall products. With s ~= 4 n the preconditioned system has
condition number ~3 REGARDLESS of cond(A) (Marchenko-Pastur: sqrt(cond) ~
(1+sqrt(n/s))/(1-sqrt(n/s))), so a FIXED ~30 iterations reach f64 machine
accuracy with nothing read back from the device.

All right-hand sides advance together as the columns of one block.

One difference from the JAX package, by design. In finite precision CGLS
wanders once it has reached the attainable accuracy, so an iterate must be
chosen. The JAX package keeps the one with the smallest residual norm
||b - A x||; but that norm is flat to second order around the solution, so
its minimum over the late iterates is set by rounding and the chosen iterate
lies ~sqrt(eps) off. Here the iterate with the smallest preconditioned
normal residual ||R^-T A^T (b - A x)|| is kept: that norm is linear in the
error, falls while the iteration converges, and rises only if it diverges.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["sketched_lstsq"]


def _sketched_cgls(a, b, s_rows, n_iters, key):
    """Preconditioned CGLS on min ||A x - b||_2, columns of ``b`` (m, k)
    side by side.

    Precondition with R from QR(S A): substitute x = R^{-1} z and run
    CGLS on (A R^{-1}); every iterate applies R^{-1} / R^{-T} by
    triangular solves (n x n) and A / A^T by tall products.
    Returns (x (n, k), normal-equation residual history (k, n_iters))."""
    m, n = a.shape
    sk = _rsvd._draw_sketch(key, (s_rows, m), a.dtype, a.device)
    sk = sk / s_rows ** 0.5
    r_mat = torch.linalg.qr(sk @ a).R
    # guard rank deficiency: floor R's diagonal at eps * max|diag|
    finfo = torch.finfo(a.dtype)
    d = torch.diagonal(r_mat)
    floor = finfo.eps * d.abs().max()
    sign = torch.where(d < 0, -torch.ones_like(d), torch.ones_like(d))
    r_mat = r_mat - torch.diag(d) + torch.diag(sign * d.abs().clamp_min(floor))

    def amat(z):          # A R^{-1} z
        return a @ torch.linalg.solve_triangular(r_mat, z, upper=True)

    def atmat(y):         # R^{-T} A^T y
        return torch.linalg.solve_triangular(r_mat.mT, a.mT @ y, upper=False)

    z = a.new_zeros((n, b.shape[1]))
    res = b
    g = atmat(res)
    p = g
    gg = torch.sum(g * g, dim=0)
    z_best, gg_best = z, gg
    hist = a.new_empty((n_iters, b.shape[1]))
    for i in range(n_iters):
        q = amat(p)
        alpha = gg / torch.sum(q * q, dim=0).clamp_min(finfo.tiny)
        z = z + alpha * p
        res = res - alpha * q
        g = atmat(res)
        gg_new = torch.sum(g * g, dim=0)
        p = g + (gg_new / gg.clamp_min(finfo.tiny)) * p
        gg = gg_new
        better = gg < gg_best
        z_best = torch.where(better, z, z_best)
        gg_best = torch.where(better, gg, gg_best)
        hist[i] = torch.sqrt(gg)
    return torch.linalg.solve_triangular(r_mat, z_best, upper=True), hist.mT


def sketched_lstsq(a, b, sketch_factor: float = 4.0, n_iters: int = 30,
                   key=0, mesh=None):
    """min_x ||A x - b||_2 by sketch-and-precondition CGLS.

    a: (m, n) with m >= n (very tall is the target regime); b: (m,) or
    (m, k), multiple right-hand sides share the sketch/QR and advance
    together; sketch_factor: sketch rows = factor*n (>= 2; 4 keeps the
    preconditioned condition number ~3); n_iters: fixed CGLS iterations
    (30 reaches f64 machine precision at factor 4); mesh: the JAX package's
    row sharding, not ported (anything but None raises).

    Returns (x, hist): the solution(s) (n,) or (n, k) and the
    preconditioned normal-residual history (n_iters,) or (k, n_iters)
    for convergence inspection.
    """
    if mesh is not None:
        raise NotImplementedError("sketched_lstsq(mesh=...) is not ported")
    a = as_tensor(a)
    if a.ndim != 2 or a.shape[0] < a.shape[1]:
        raise ValueError(
            f"a must be (m >= n, n) tall, got {tuple(a.shape)}"
        )
    m, n = int(a.shape[0]), int(a.shape[1])
    if sketch_factor < 2.0:
        raise ValueError(
            f"sketch_factor must be >= 2, got {sketch_factor}"
        )
    s_rows = min(max(int(round(sketch_factor * n)), n + 8), m)
    bb = as_tensor(b, device=a.device)
    squeeze = bb.ndim == 1
    if squeeze:
        bb = bb[:, None]
    if bb.shape[0] != m:
        raise ValueError(f"b must have {m} rows, got {tuple(bb.shape)}")
    xs, hists = _sketched_cgls(a, bb, s_rows, int(n_iters), key)
    if squeeze:
        return xs[:, 0], hists[0]
    return xs, hists
