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


def _sketched_cgls(a, b, s_rows, n_iters, key, rows=None):
    """Preconditioned CGLS on min ||A x - b||_2, columns of ``b`` (m, k)
    side by side.

    Precondition with R from QR(S A): substitute x = R^{-1} z and run
    CGLS on (A R^{-1}); every iterate applies R^{-1} / R^{-T} by
    triangular solves (n x n) and A / A^T by tall products.
    ``rows`` = (m, offset, psum) when ``a`` and ``b`` are this rank's rows
    of a row-sharded system: the sketch S is drawn whole and this rank's
    columns taken, and the contractions over m (S A, A^T r, ||A p||^2)
    are psummed; the (n, n) algebra is replicated.
    Returns (x (n, k), normal-equation residual history (k, n_iters))."""
    m, n = a.shape
    lo, psum = 0, (lambda t: t)
    if rows is not None:
        m, lo, psum = rows
    sk = _rsvd._draw_sketch(key, (s_rows, m), a.dtype, a.device)
    sk = sk[:, lo:lo + a.shape[0]] / s_rows ** 0.5
    r_mat = torch.linalg.qr(psum(sk @ a)).R
    # guard rank deficiency: floor R's diagonal at eps * max|diag|
    finfo = torch.finfo(a.dtype)
    d = torch.diagonal(r_mat)
    floor = finfo.eps * d.abs().max()
    sign = torch.where(d < 0, -torch.ones_like(d), torch.ones_like(d))
    r_mat = r_mat - torch.diag(d) + torch.diag(sign * d.abs().clamp_min(floor))

    def amat(z):          # A R^{-1} z
        return a @ torch.linalg.solve_triangular(r_mat, z, upper=True)

    def atmat(y):         # R^{-T} A^T y
        return torch.linalg.solve_triangular(r_mat.mT, psum(a.mT @ y),
                                             upper=False)

    z = a.new_zeros((n, b.shape[1]))
    res = b
    g = atmat(res)
    p = g
    gg = torch.sum(g * g, dim=0)
    z_best, gg_best = z, gg
    hist = a.new_empty((n_iters, b.shape[1]))
    for i in range(n_iters):
        q = amat(p)
        alpha = gg / psum(torch.sum(q * q, dim=0)).clamp_min(finfo.tiny)
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
    (30 reaches f64 machine precision at factor 4); mesh: a DeviceMesh
    (``parallel.mesh.make_mesh``; every rank calls) over whose first axis
    the rows of A and b (the long axis) shard (DTensors sharded so, or
    full arrays every rank holds; m must divide the axis size): every
    contraction over m (the sketch, A^T r) is one psum, and the small
    (s, n)/(n, n) algebra is replicated, as is x.

    Returns (x, hist): the solution(s) (n,) or (n, k) and the
    preconditioned normal-residual history (n_iters,) or (k, n_iters)
    for convergence inspection.
    """
    rows = None
    if mesh is not None:
        from corrla_rs_tpu_torch.parallel.mesh import _axis, _coord, _local, \
            _psum, _size

        axis = _axis(mesh, None)
        shape, b_rows = tuple(a.shape), tuple(b.shape)[:1]
        n_dev = _size(mesh, axis)
        if len(shape) == 2 and shape[0] >= shape[1] and shape[0] % n_dev:
            raise ValueError(f"rows ({shape[0]}) must divide the mesh axis "
                             f"size ({n_dev})")
        a, _ = _local(a, mesh, axis)
    else:
        a = as_tensor(a)
        shape = tuple(a.shape)
    if len(shape) != 2 or shape[0] < shape[1]:
        raise ValueError(
            f"a must be (m >= n, n) tall, got {shape}"
        )
    m, n = shape
    if sketch_factor < 2.0:
        raise ValueError(
            f"sketch_factor must be >= 2, got {sketch_factor}"
        )
    s_rows = min(max(int(round(sketch_factor * n)), n + 8), m)
    if mesh is not None:
        if b_rows != (m,):
            raise ValueError(f"b must have {m} rows, got {tuple(b.shape)}")
        bb, _ = _local(b, mesh, axis, device=a.device)
        rows = (m, _coord(mesh, axis) * a.shape[0],
                lambda t: _psum(t, mesh, axis))
    else:
        bb = as_tensor(b, device=a.device)
        if bb.shape[0] != m:
            raise ValueError(f"b must have {m} rows, got {tuple(bb.shape)}")
    squeeze = bb.ndim == 1
    if squeeze:
        bb = bb[:, None]
    xs, hists = _sketched_cgls(a, bb, s_rows, int(n_iters), key, rows)
    if squeeze:
        return xs[:, 0], hists[0]
    return xs, hists
