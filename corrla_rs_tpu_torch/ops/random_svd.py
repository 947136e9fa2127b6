"""Randomized SVD: the compute core every model composes.

Counterpart of ``corrla_rs_tpu/ops/random_svd.py``. Halko / Martinsson-Tropp
range finder with subspace power iteration, parity with the reference
random_svd.rs:15-110:

- Gaussian sketch Omega (m, k), Y = A Omega, then ``n_iter`` iterations of
  Y <- A (A^T Y), each followed by a Frobenius-norm rescale;
- thin QR inside the loop every iteration (``stabilize='always'``) or only
  when the iteration index is > 2 (``'reference'``);
- final Householder QR, B = Q^T A, dense SVD of the small B, U = Q U_B;
- fat inputs (nrows < ncols) go through the transpose.

Beyond the reference, as in the JAX package: ``block_krylov_svd`` keeps every
power iterate in one preallocated Krylov block, and ``single_pass_svd`` reads
A exactly twice (a range sketch and a co-range sketch).

The big products run through cuBLAS in full f32 (TF32 is off, see
``utils.device``); QR, Cholesky, the k x k triangular inverses and the small
SVD are ``torch.linalg`` (cuSOLVER on the GPU), as the JAX package leaves
them to XLA. A CholeskyQR round applies its factor's inverse to the tall
panel as one product, not as a triangular solve over the panel's rows.
The loop is a Python loop over a Python int, so nothing in it synchronises
with the device.
"""
from __future__ import annotations

import functools

import torch

from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator, fold_seed, split_seed
from corrla_rs_tpu_torch.utils.tracing import annotate

__all__ = ["power_iter", "random_svd", "block_krylov_svd", "single_pass_svd"]

# The seams through which a seed becomes child seeds: every module of the
# randomized family splits (and folds) here, so the parity tests replace
# these two with the JAX package's key arithmetic.
_split_seed = split_seed
_fold_seed = fold_seed

# the spans inside ``corrla.rsvd`` (see utils.tracing)
_PRODUCTS, _ORTH, _SVD = ("corrla.rsvd.products", "corrla.rsvd.orth",
                          "corrla.rsvd.svd")


def _draw_sketch(seed_or_gen, shape, dtype, device) -> torch.Tensor:
    """Standard-normal sketch Omega of ``shape``.

    The one place the randomized SVD draws random numbers. torch cannot
    reproduce ``jax.random.normal``, so the parity tests replace this
    function with one that returns the JAX draw for the same seed.
    """
    gen = as_generator(seed_or_gen, device)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


# A member stack's product over a long contraction runs as one cuBLAS
# strided-batched GEMM, which sums the whole contraction in one pass: over
# 20,002 rows on an H100 it read 5.3e-6 of the product's largest entry,
# against 4.5e-7 for one GEMM a member (tests/ensemble_accuracy_probe.py),
# and the DMDc ensemble's eigenvalues lost a digit to it. Summing the
# products of chunks of this many rows restores one GEMM's accuracy.
_MEMBER_CHUNK = 1024


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b. For member stacks (3-D) whose contraction is longer than
    ``_MEMBER_CHUNK``, the sum of the products over its chunks, accumulated
    by ``baddbmm_``; a 2-D product is exactly ``a @ b``."""
    n = a.shape[-1]
    if a.ndim != 3 or n <= _MEMBER_CHUNK:
        return a @ b
    c = _MEMBER_CHUNK
    out = a[..., :c] @ b[..., :c, :]
    for i in range(c, n, c):
        out.baddbmm_(a[..., i:i + c], b[..., i:i + c, :])
    return out


def _householder_qr(y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(y, mode="reduced").Q


def _round_constants(dtype):
    """(small ridge, large ridge, column-norm floor) of a CholeskyQR round
    of a panel in ``dtype``."""
    if dtype == torch.float32:
        # the big ridge must exceed the worst negative eigenvalue of a
        # rounded deficient Gram (~k sqrt(n) 2^-24); the next round's
        # small-ridge pass removes the distortion it introduces
        return 1e-7, 1e-2, 1e-30
    return 1e-15, 1e-8, 1e-290


def _ridges(y, eps_small, eps_big):
    """(I, the stack [eps_small I, eps_big I]) for the k columns of the
    panel ``y``, the ridges' axis in front of any member axis of ``y``.
    Made once a call and used by each of its rounds."""
    eye = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
    ridges = torch.stack([eps_small * eye, eps_big * eye])
    return eye, ridges.reshape((2,) + (1,) * (y.ndim - 2) + eye.shape)


def _ridged_r_inv(g, eye, ridges):
    """R^-1 of the upper Cholesky factor of the k x k Gram ``g`` (or of each
    of a member stack) with a ridge fallback: ``g`` plus each ridge of
    ``ridges`` (from ``_ridges``) in one batched ``cholesky_ex``, and the
    large-ridge factor wherever the small-ridge one failed (``info``, or a
    non-finite value, which is what the JAX package tests): deficient
    panels, whose Gram is indefinite at working precision. The choice is a
    ``torch.where`` on the device, so nothing synchronises with the host.
    Every CholeskyQR of the package factors here."""
    (r_small, r_big), (info, _) = torch.linalg.cholesky_ex(g + ridges,
                                                           upper=True)
    ok = (info == 0) & torch.isfinite(r_small).all(dim=(-2, -1))
    r = torch.where(ok[..., None, None], r_small, r_big)
    return torch.linalg.solve_triangular(r, eye, upper=True)


def _cholesky_qr2(y: torch.Tensor) -> torch.Tensor:
    """Preconditioned CholeskyQR with ridge fallback (3 rounds).

    Per round: column-normalize, form the k x k Gram, take R^-1 of its
    ridge-fallback Cholesky factor (``_ridged_r_inv``) and return the panel
    times R^-1 as one product: equal in exact arithmetic to a triangular
    solve over the panel's n rows, which runs far below its bound on the
    GPU. No round synchronises with the host.

    ``y`` may carry a leading member dimension (a stack of members): every
    norm, Gram and ridge choice is then taken per member.

    ``_cholesky_qr2.rounds`` counts the rounds run in this process (three a
    call), on the host; the row-sharded rounds of ``parallel.sharded_rsvd``
    add to it too.
    """
    eps_small, eps_big, tiny = _round_constants(y.dtype)
    eye, ridges = _ridges(y, eps_small, eps_big)

    def one_round(y):
        cn = torch.linalg.vector_norm(y, dim=-2, keepdim=True).clamp_min(tiny)
        ys = y / cn
        m = _ridged_r_inv(_mm(ys.mT, ys), eye, ridges)
        _cholesky_qr2.rounds += 1
        return _mm(ys, m)

    return one_round(one_round(one_round(y)))


_cholesky_qr2.rounds = 0


def _thin_qr(y: torch.Tensor, qr_method: str = "householder") -> torch.Tensor:
    if qr_method == "cholesky":
        return _cholesky_qr2(y)
    return _householder_qr(y)


def _resolve(dtype, stabilize: str, qr_method: str):
    """``stabilize`` and ``qr_method`` with 'auto' resolved for ``dtype``."""
    if stabilize == "auto":
        stabilize = "always" if dtype == torch.float32 else "reference"
    if qr_method == "auto":
        qr_method = "cholesky" if stabilize == "always" else "householder"
    return stabilize, qr_method


def _range_finder(a, omega, n_iter: int, stabilize: str, qr_method: str):
    """Q of the power iteration started from the sketch ``omega``; ``a``
    and ``omega`` may carry the same leading member dimension. Each product
    that reads ``a`` is a span ``corrla.rsvd.products``, each
    orthonormalization a span ``corrla.rsvd.orth``."""
    with annotate(_PRODUCTS):
        y = a @ omega
    for i in range(n_iter):
        if stabilize == "always" or i > 2:
            with annotate(_ORTH):
                y = _thin_qr(y, qr_method)
        with annotate(_PRODUCTS):
            z = _mm(a.mT, y)
        with annotate(_PRODUCTS):
            y = a @ z
        # guard: a zero panel (e.g. A == 0) must not produce 0/0 = NaN
        y = y / torch.linalg.vector_norm(y, dim=(-2, -1),
                                         keepdim=True).clamp_min(1e-30)
    # the final orthonormalization sets B = Q^T A and every sigma after it:
    # exact Householder even on the cholesky fast path
    with annotate(_ORTH):
        return _householder_qr(y)


def power_iter(a: torch.Tensor, omega_rank: int, n_iter: int, key=0,
               stabilize: str = "auto",
               qr_method: str = "auto") -> torch.Tensor:
    """Randomized range finder: orthonormal Q (n, omega_rank) for range(A).

    Parity with reference random_svd.rs:15-59. ``key`` is an int seed or a
    ``torch.Generator``. ``stabilize``: 'auto' ('always' for f32,
    'reference' for f64), 'reference' (thin QR only when the iteration
    index is > 2) or 'always'. ``qr_method``: 'auto' (cholesky when
    stabilize resolves to 'always', householder otherwise), 'householder'
    or 'cholesky'. The final orthonormalization is always Householder.
    """
    a = as_tensor(a)
    n, m = a.shape
    omega = _draw_sketch(key, (m, omega_rank), a.dtype, a.device)
    return _range_finder(a, omega, n_iter,
                         *_resolve(a.dtype, stabilize, qr_method))


def _widths(m: int, omega_rank: int, n_oversamples: int):
    """(sketch rank, returned rank) of a randomized SVD of a tall matrix
    with ``m`` columns."""
    sketch_rank = min(int(omega_rank) + int(n_oversamples), m)
    return sketch_rank, min(int(omega_rank), sketch_rank)


def random_svd(a: torch.Tensor, omega_rank: int, n_iter: int,
               n_oversamples: int, key=0, stabilize: str = "auto",
               qr_method: str = "auto"):
    """Randomized SVD: A ~= U diag(s) Vt with U (n, r), s (r,), Vt (r, m).

    Parity with reference random_svd.rs:63-110, including the fat-matrix
    transpose path. ``key`` is an int seed or a ``torch.Generator``. Under
    a ``torch.profiler`` profile the call is the span ``corrla.rsvd``, and
    inside it each product that reads A is a span ``corrla.rsvd.products``
    (2 + 2 ``n_iter``), each orthonormalization a span ``corrla.rsvd.orth``
    and the SVD of B = Q^T A with U = Q U_B the span ``corrla.rsvd.svd``.
    """
    return _rsvd(a, omega_rank, n_iter, n_oversamples, stabilize, qr_method,
                 functools.partial(_draw_sketch, key))


def _random_svd_members(a: torch.Tensor, omega_rank: int, n_iter: int,
                        n_oversamples: int, keys, stabilize: str = "auto",
                        qr_method: str = "auto"):
    """``random_svd`` of every member of the stack ``a`` (B, n, m) in one
    batched pass: U (B, n, r), s (B, r), Vt (B, r, m), with the same spans.

    Member b draws its sketch from ``keys[b]``, as ``random_svd(a[b],
    key=keys[b])`` would; the draws are stacked and every product, QR,
    Cholesky and SVD after them is one call over the member axis, with
    each norm and ridge choice taken per member.
    """
    return _rsvd(a, omega_rank, n_iter, n_oversamples, stabilize, qr_method,
                 lambda shape, dtype, device: torch.stack(
                     [_draw_sketch(k, shape, dtype, device) for k in keys]))


def _rsvd(a, omega_rank, n_iter, n_oversamples, stabilize, qr_method, draw):
    """The body of ``random_svd`` and ``_random_svd_members``: ``draw(shape,
    dtype, device)`` makes the (m, k) sketch, a stack of them for a stack."""
    with annotate("corrla.rsvd"):
        a = as_tensor(a)
        fat = a.shape[-2] < a.shape[-1]
        aa = a.mT if fat else a
        sketch_rank, rank = _widths(aa.shape[-1], omega_rank, n_oversamples)
        omega = draw((aa.shape[-1], sketch_rank), aa.dtype, aa.device)
        q = _range_finder(aa, omega, n_iter,
                          *_resolve(aa.dtype, stabilize, qr_method))
        with annotate(_PRODUCTS):
            b = _mm(q.mT, aa)
        with annotate(_SVD):
            u_b, s, vt = torch.linalg.svd(b, full_matrices=False)
            u = q @ u_b
        return _truncate(u, s, vt, rank, fat)


def _truncate(u, s, vt, rank: int, fat: bool):
    if fat:
        # A = V S (Q U_B)^T   since A^T ~= (Q U_B) S V^T
        return vt.mT[..., :rank], s[..., :rank], u.mT[..., :rank, :]
    return u[..., :rank], s[..., :rank], vt[..., :rank, :]


def block_krylov_svd(a: torch.Tensor, rank: int, n_iter: int,
                     n_oversamples: int = 10, key=0):
    """Randomized block-Krylov SVD (Musco & Musco 2015, arxiv 1504.05477).

    Beyond the reference, which only has subspace iteration: the whole
    Krylov block

        K = [A Omega, (A A^T) A Omega, ..., (A A^T)^q A Omega]

    is kept and its range taken. The same number of passes over A as
    ``n_iter`` subspace iterations, but on gapless spectra the sigma error
    at a fixed pass budget is typically an order of magnitude smaller. The
    final QR and SVD run on an (n, k (q + 1)) block instead of (n, k). The
    block is allocated once and each iterate is written into its slice.

    Returns (U (n, rank), s (rank,), Vt (rank, m)) like ``random_svd``.
    """
    a = as_tensor(a)
    fat = a.shape[0] < a.shape[1]
    aa = a.mT if fat else a
    n, m = aa.shape
    k, _ = _widths(m, rank, n_oversamples)
    q = max(int(n_iter), 0)
    omega = _draw_sketch(key, (m, k), aa.dtype, aa.device)
    blocks = aa.new_empty((n, k * (q + 1)))
    y = torch.matmul(aa, omega, out=blocks[:, :k])
    for i in range(q):
        # orthonormalize the running block for numerical range quality
        y = _cholesky_qr2(y)
        y = torch.matmul(aa, aa.mT @ y, out=blocks[:, (i + 1) * k:(i + 2) * k])
    q_full = _householder_qr(blocks)
    u_b, s, vt = torch.linalg.svd(q_full.mT @ aa, full_matrices=False)
    return _truncate(q_full @ u_b, s, vt, rank, fat)


def single_pass_svd(a: torch.Tensor, rank: int, n_oversamples: int = 10,
                    core_oversamples: int | None = None, key=0):
    """Two-sided sketch SVD (Tropp, Yurtsever, Udell & Cevher 2017,
    "Practical sketching algorithms for low-rank matrix approximation").

    Beyond the reference: reads A exactly twice (the range sketch
    Y = A Omega and the co-range sketch W = Psi A; in a streaming setting
    both accumulate in one pass), against 1 + 2 n_iter passes for
    ``random_svd``. The price is accuracy on flat spectra: with no power
    iteration the sketch captures sigma_i only up to the usual (sum of the
    tail) / (gap) factors. Use it when the spectrum decays or when A cannot
    be revisited; ``random_svd`` and ``block_krylov_svd`` are the accuracy
    path.

    core_oversamples: extra rows of the co-range sketch (l = k + this).
    Tropp et al. recommend l ~ 2k for a stable core solve; the default is
    l = 2k + 1, capped by the matrix dimensions.

    A row-sharded DTensor ``a`` (tall: n >= m) runs the same algorithm on
    each rank's rows, every rank calling: Y = A Omega stays row-sharded, W =
    Psi A and Psi Q are psums of the products of the columns of Psi that
    meet the rank's rows (Psi and Omega are drawn whole, as here), and the
    QR of Y is an exact TSQR. U comes back a DTensor with ``Shard(0)``; s
    and Vt are replicated.

    Returns (U (n, rank), s (rank,), Vt (rank, m)) like ``random_svd``.
    """
    from corrla_rs_tpu_torch.parallel import mesh, sharded_rsvd

    rows = mesh.rows_of_dtensor(a)
    if rows is not None:
        return sharded_rsvd._single_pass_sharded(rows, rank, n_oversamples,
                                                 core_oversamples, key)
    a = as_tensor(a)
    fat = a.shape[0] < a.shape[1]
    aa = a.mT if fat else a
    n, m = aa.shape
    k, ell = _single_pass_widths(n, m, rank, n_oversamples,
                                 core_oversamples)
    k_om, k_psi = _split_seed(key, 2, aa.device)
    omega = _draw_sketch(k_om, (m, k), aa.dtype, aa.device)
    psi = _draw_sketch(k_psi, (ell, n), aa.dtype, aa.device)
    y = aa @ omega                                      # pass 1: (n, k)
    w = psi @ aa                                        # pass 2: (ell, m)
    q = _householder_qr(y)                              # (n, k)
    u_x, s, vt = _core_svd(psi @ q, w)
    return _truncate(q @ u_x, s, vt, rank, fat)


def _core_svd(psi_q, w):
    """SVD of the two-sided sketch's core X = (Psi Q)^+ W (k, m), by QR
    least squares: Psi Q (ell, k) is small and well conditioned w.h.p. for
    ell ~ 2k. Every ``single_pass_svd`` of the package (dense, row-sharded,
    streamed) solves its core here."""
    qb, rb = torch.linalg.qr(psi_q, mode="reduced")
    x = torch.linalg.solve_triangular(rb, qb.mT @ w, upper=True)
    return torch.linalg.svd(x, full_matrices=False)


def _single_pass_widths(n: int, m: int, rank: int, n_oversamples: int,
                        core_oversamples):
    """(k, ell): the range sketch's and the co-range sketch's widths."""
    k, _ = _widths(m, rank, n_oversamples)
    if core_oversamples is None:
        return k, min(2 * k + 1, n)
    return k, min(k + int(core_oversamples), n)
