"""Multi-device randomized SVD: a row-sharded tall matrix over a mesh.

Counterpart of ``corrla_rs_tpu/parallel/sharded_rsvd.py``. The tall matrix
A (n, m) is split along its rows across the mesh axis; each rank runs the
local products and the collectives join them. Per power iteration:

    Y_l   = A_l @ Omega                       (local GEMM)
    Z     = allreduce(A_l^T @ Y_l)            (Gram reduction)
    Y_l   = A_l @ Z                           (local GEMM)

The in-loop thin QR is the three rounds of ``ops.random_svd._cholesky_qr2``
with the column norms and the Gram all-reduced (two k x k all-reduces a
round) and R^-1 from ``ops.random_svd._ridged_r_inv``; the widths and
``stabilize`` are ``ops.random_svd``'s too. The loops are this module's own,
since their products are collectives. The final orthonormalization is an
exact TSQR (``_tsqr``): a local Householder QR, an all-gather of the k x k
R factors, one replicated QR of their stack, and this rank's block of its
Q. B = allreduce(Q_l^T A_l) and its small SVD are replicated on every rank.
``ops.random_svd.single_pass_svd`` of a row-sharded DTensor runs here too
(``_single_pass_sharded``), on the same TSQR.

Omega is drawn whole through ``ops.random_svd._draw_sketch``, so the same
key gives the same sketch on every rank and in the single-device
``random_svd``. The local products are the same ``torch.matmul`` with TF32
off as in ``ops.random_svd``.

The body also takes a replicated ``tail`` of extra rows that every rank
holds: the matrix is then [A sharded; tail], and the tail's share of every
reduction is added once, after the all-reduce (``models.dmd`` puts DMDc's
control rows there).
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import random_svd as _rsvd
from corrla_rs_tpu_torch.parallel.mesh import (
    _all_gather,
    _axis,
    _coord,
    _dtensor,
    _local,
    _psum,
    _size,
    make_mesh,
)

__all__ = ["sharded_random_svd", "sharded_power_iter_qr"]


def _reduce(local, tail_part, mesh, axis_name):
    """allreduce(local) plus the replicated tail's share, added once."""
    total = _psum(local, mesh, axis_name)
    return total if tail_part is None else total + tail_part


def _chol_qr2(y_l, y_t, mesh, axis_name):
    """The three rounds of ``ops.random_svd._cholesky_qr2`` on the sharded
    panel y_l (and the replicated tail y_t): the column norms and the Gram
    are all-reduced, R^-1 is ``random_svd._ridged_r_inv``'s, replicated,
    and each rank multiplies its rows by it. Counted in
    ``_cholesky_qr2.rounds``."""
    eps_small, eps_big, tiny = _rsvd._round_constants(y_l.dtype)
    eye, ridges = _rsvd._ridges(y_l, eps_small, eps_big)
    for _ in range(3):
        cn2 = _reduce(torch.sum(y_l * y_l, dim=0),
                      None if y_t is None else torch.sum(y_t * y_t, dim=0),
                      mesh, axis_name)
        cn = torch.sqrt(cn2).clamp_min(tiny)
        y_l = y_l / cn[None, :]
        y_t = None if y_t is None else y_t / cn[None, :]
        g = _reduce(y_l.mT @ y_l, None if y_t is None else y_t.mT @ y_t,
                    mesh, axis_name)
        m = _rsvd._ridged_r_inv(g, eye, ridges)
        _rsvd._cholesky_qr2.rounds += 1
        y_l = y_l @ m
        y_t = None if y_t is None else y_t @ m
    return y_l, y_t


def _tsqr_factors(y_l, y_t, mesh, axis_name):
    """Exact thin QR of [y_l sharded; y_t replicated] (one-level TSQR).

    Local Householder QR of each shard's (n_local, k) panel, an all-gather
    of the R factors, one replicated Householder QR of their stack (with
    the tail's rows below it), then Q_l @ (this rank's block of Q_r).
    Backward stable like Householder, so it is the final orthonormalization
    of the range finder. Returns (Q_l, Q_tail, R), R replicated."""
    q_l, r_l = torch.linalg.qr(y_l, mode="reduced")
    r_all = _all_gather(r_l, mesh, axis_name)
    stacked = r_all if y_t is None else torch.cat([r_all, y_t])
    q_r, r = torch.linalg.qr(stacked, mode="reduced")
    kk = r_l.shape[0]
    idx = _coord(mesh, axis_name)
    q_l = q_l @ q_r[idx * kk:(idx + 1) * kk]
    return q_l, None if y_t is None else q_r[r_all.shape[0]:], r


def _tsqr(y_l, y_t, mesh, axis_name):
    """``_tsqr_factors`` without R: (Q_l, Q_tail)."""
    return _tsqr_factors(y_l, y_t, mesh, axis_name)[:2]


def _single_pass_sharded(rows, rank, n_oversamples, core_oversamples, key):
    """``ops.random_svd.single_pass_svd`` of a row-sharded DTensor (``rows``
    from ``parallel.mesh.rows_of_dtensor``): Y = A Omega stays row-sharded,
    W = Psi A and Psi Q are psums, and the QR of Y is ``_tsqr``."""
    a_l, (n, m), mesh, axis = rows
    if n < m:
        raise ValueError(
            f"single_pass_svd of a row-sharded matrix needs it tall (n >= "
            f"m), got {n} x {m}")
    k, ell = _rsvd._single_pass_widths(n, m, rank, n_oversamples,
                                       core_oversamples)
    k_om, k_psi = _rsvd._split_seed(key, 2, a_l.device)
    omega = _rsvd._draw_sketch(k_om, (m, k), a_l.dtype, a_l.device)
    n_l = a_l.shape[0]
    lo = _coord(mesh, axis) * n_l
    psi_l = _rsvd._draw_sketch(k_psi, (ell, n), a_l.dtype,
                               a_l.device)[:, lo:lo + n_l]
    y_l = a_l @ omega                                   # pass 1, sharded
    w = _psum(psi_l @ a_l, mesh, axis)                  # pass 2: (ell, m)
    q_l, _ = _tsqr(y_l, None, mesh, axis)
    u_x, s, vt = _rsvd._core_svd(_psum(psi_l @ q_l, mesh, axis), w)
    u_l = (q_l @ u_x)[:, :rank]
    return (_dtensor(u_l, mesh, axis, 0, (n, u_l.shape[1])), s[:rank],
            vt[:rank, :])


def _power_iter_sharded(a_l, a_t, omega, n_iter, stabilize, mesh, axis_name):
    """Row-sharded randomized range finder of [a_l; a_t]; returns
    (Q_l, Q_tail)."""
    y_l = a_l @ omega
    y_t = None if a_t is None else a_t @ omega
    for i in range(int(n_iter)):
        if stabilize == "always" or i > 2:
            y_l, y_t = _chol_qr2(y_l, y_t, mesh, axis_name)
        z = _reduce(a_l.mT @ y_l, None if a_t is None else a_t.mT @ y_t,
                    mesh, axis_name)
        y_l = a_l @ z
        y_t = None if a_t is None else a_t @ z
        norm2 = _reduce(torch.sum(y_l * y_l),
                        None if y_t is None else torch.sum(y_t * y_t),
                        mesh, axis_name)
        scale = torch.sqrt(norm2).clamp_min(1e-30)
        y_l = y_l / scale
        y_t = None if y_t is None else y_t / scale
    return _tsqr(y_l, y_t, mesh, axis_name)


def sharded_power_iter_qr(a_l, omega, n_iter, stabilize, axis_name, mesh):
    """The randomized range finder on this rank's rows ``a_l``: returns
    this rank's rows of the orthonormal Q. Every rank of the mesh axis
    calls it with its own rows and the same ``omega``. (JAX finds the mesh
    from inside ``shard_map``; torch has no ambient mesh, so it is passed.)
    """
    return _power_iter_sharded(a_l, None, omega, n_iter, stabilize, mesh,
                               axis_name)[0]


def _check_tall(n: int, m: int, n_dev: int) -> None:
    """The sharded SVD's layout: tall, rows divisible by the axis size."""
    if n < m:
        raise ValueError(
            "sharded_random_svd expects a tall (n >= m) matrix; transpose "
            "fat inputs at the caller (layout choice)"
        )
    if n % n_dev != 0:
        raise ValueError(
            f"rows ({n}) must divide the mesh axis size ({n_dev})"
        )


def _sharded_svd(a_l, a_t, m, omega_rank, n_iter, n_oversamples, key,
                 stabilize, mesh, axis_name):
    """The body of every sharded randomized SVD: (U_l, U_tail, s, Vt) of
    [a_l; a_t] (m columns), truncated to the rank, s and Vt replicated."""
    sketch_rank, rank = _rsvd._widths(m, omega_rank, n_oversamples)
    stabilize, _ = _rsvd._resolve(a_l.dtype, stabilize, "auto")
    omega = _rsvd._draw_sketch(key, (m, sketch_rank), a_l.dtype, a_l.device)
    q_l, q_t = _power_iter_sharded(a_l, a_t, omega, n_iter, stabilize, mesh,
                                   axis_name)
    b = _reduce(q_l.mT @ a_l, None if a_t is None else q_t.mT @ a_t, mesh,
                axis_name)
    u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
    u_b = u_b[:, :rank]
    return (q_l @ u_b, None if q_t is None else q_t @ u_b, s[:rank],
            vt[:rank, :])


def _col_sharded_svd(a_l, n, m, omega_rank, n_iter, n_oversamples, key,
                     stabilize, mesh, axis_name):
    """The randomized SVD of a tall (n, m) matrix whose COLUMNS are
    sharded, ``a_l`` this rank's (n, m_local) block: the panel Y (n, k) is
    replicated, each product with A a psum of the blocks' products, and
    its QRs are ``ops.random_svd``'s own; B^T = A^T Q (m, k) comes out
    row-sharded and is factored by ``_tsqr_factors``, B = R^T Qb^T, so
    B's SVD is that of the small R^T. Returns (U, s, Vt_local) truncated
    to the rank: U and s replicated, Vt's columns this rank's block."""
    sketch_rank, rank = _rsvd._widths(m, omega_rank, n_oversamples)
    stabilize, qr_method = _rsvd._resolve(a_l.dtype, stabilize, "auto")
    m_l = a_l.shape[1]
    lo = _coord(mesh, axis_name) * m_l
    omega = _rsvd._draw_sketch(key, (m, sketch_rank), a_l.dtype,
                               a_l.device)[lo:lo + m_l]
    y = _psum(a_l @ omega, mesh, axis_name)
    for i in range(int(n_iter)):
        if stabilize == "always" or i > 2:
            y = _rsvd._thin_qr(y, qr_method)
        y = _psum(a_l @ (a_l.mT @ y), mesh, axis_name)
        y = y / torch.linalg.vector_norm(y).clamp_min(1e-30)
    q = _rsvd._householder_qr(y)
    qb_l, _, r = _tsqr_factors(a_l.mT @ q, None, mesh, axis_name)
    u_r, s, w_t = torch.linalg.svd(r.mT, full_matrices=False)
    return ((q @ u_r)[:, :rank], s[:rank],
            (qb_l @ w_t.mT)[:, :rank].mT)


def _svd_of_sharded(a_l, shape, dim, omega_rank, n_iter, n_oversamples,
                    key, mesh, axis_name, stabilize="auto"):
    """``ops.random_svd.random_svd`` of the matrix of global ``shape``
    whose rows (``dim`` 0) or columns (``dim`` 1) are sharded, ``a_l``
    this rank's block. Like random_svd, a fat matrix is factored through
    its transpose, so each of the four cases is a row-sharded
    (``_sharded_svd``) or a column-sharded (``_col_sharded_svd``) tall
    one. Returns (U, s, Vt) truncated to the rank: the factor along the
    sharded dimension (U for rows, Vt for columns) as this rank's block,
    the rest replicated."""
    rows, cols = shape
    fat = rows < cols
    aa_l = a_l.mT if fat else a_l
    n, m = (cols, rows) if fat else (rows, cols)
    if (dim == 0) != fat:
        u, _, s, vt = _sharded_svd(aa_l, None, m, omega_rank, n_iter,
                                   n_oversamples, key, stabilize, mesh,
                                   axis_name)
    else:
        u, s, vt = _col_sharded_svd(aa_l, n, m, omega_rank, n_iter,
                                    n_oversamples, key, stabilize, mesh,
                                    axis_name)
    return (vt.mT, s, u.mT) if fat else (u, s, vt)


def sharded_random_svd(a, omega_rank: int, n_iter: int, n_oversamples: int,
                       key=0, stabilize: str = "always", mesh=None,
                       axis_name: str | None = None):
    """Randomized SVD of a tall row-sharded matrix over a device mesh.

    Every rank of the mesh calls it. Args:
      a: (n, m) with n >= m, n divisible by the mesh axis size: a DTensor
         sharded along its rows on the axis, or the full matrix on every
         rank (each keeps its own rows).
      key: an int seed or a ``torch.Generator`` (in the same state on every
         rank): Omega is drawn whole, as ``random_svd`` draws it.
      stabilize: 'always' (default here: CholeskyQR2 is cheap next to the
         sharded products and much safer in f32) or 'reference'.
      mesh: a DeviceMesh; default a CUDA mesh over the whole world.
    Returns:
      (U (n, r) as a DTensor sharded along its rows, s (r,), Vt (r, m)),
      s and Vt replicated: the semantics of ops.random_svd.random_svd for
      the same key, up to the order of the sums.
    """
    mesh = mesh if mesh is not None else make_mesh()
    axis_name = _axis(mesh, axis_name)
    n, m = a.shape
    _check_tall(n, m, _size(mesh, axis_name))
    a_l, _ = _local(a, mesh, axis_name)
    u_l, _, s, vt = _sharded_svd(a_l, None, m, omega_rank, n_iter,
                                 n_oversamples, key, stabilize, mesh,
                                 axis_name)
    return _dtensor(u_l, mesh, axis_name, 0, (n, u_l.shape[1])), s, vt
