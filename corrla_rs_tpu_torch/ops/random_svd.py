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
``utils.device``); QR, Cholesky, triangular solves and the small SVD are
``torch.linalg`` (cuSOLVER on the GPU), as the JAX package leaves them to
XLA. The loop is a Python loop over a Python int, so nothing in it
synchronises with the device.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.prng import as_generator, fold_seed, split_seed

__all__ = ["power_iter", "random_svd", "block_krylov_svd", "single_pass_svd"]

# The seams through which a seed becomes child seeds: every module of the
# randomized family splits (and folds) here, so the parity tests replace
# these two with the JAX package's key arithmetic.
_split_seed = split_seed
_fold_seed = fold_seed


def _draw_sketch(seed_or_gen, shape, dtype, device) -> torch.Tensor:
    """Standard-normal sketch Omega of ``shape``.

    The one place the randomized SVD draws random numbers. torch cannot
    reproduce ``jax.random.normal``, so the parity tests replace this
    function with one that returns the JAX draw for the same seed.
    """
    gen = as_generator(seed_or_gen, device)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)


def _householder_qr(y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(y, mode="reduced").Q


def _cholesky_qr2(y: torch.Tensor) -> torch.Tensor:
    """Preconditioned CholeskyQR with ridge fallback (3 rounds).

    Per round: column-normalize, form the k x k Gram, Cholesky with a small
    ridge and, where that factorization fails (deficient panels, whose Gram
    is indefinite at working precision), take the one with a large ridge
    instead. ``cholesky_ex`` reports failure in ``info`` instead of raising,
    and the choice is a ``torch.where`` on the device, so no round
    synchronises with the host. The small-ridge result also counts as failed
    if it holds a non-finite value, which is what the JAX package tests.
    """
    if y.dtype == torch.float32:
        # the big ridge must exceed the worst negative eigenvalue of a
        # rounded deficient Gram (~k sqrt(n) 2^-24); the next round's
        # small-ridge pass removes the distortion it introduces
        eps_small, eps_big, tiny = 1e-7, 1e-2, 1e-30
    else:
        eps_small, eps_big, tiny = 1e-15, 1e-8, 1e-290
    eye = torch.eye(y.shape[1], dtype=y.dtype, device=y.device)

    def one_round(y):
        cn = torch.linalg.vector_norm(y, dim=0).clamp_min(tiny)
        ys = y / cn[None, :]
        g = ys.mT @ ys
        r_small, info = torch.linalg.cholesky_ex(g + eps_small * eye,
                                                 upper=True)
        ok = (info == 0) & torch.isfinite(r_small).all()
        r_big, _ = torch.linalg.cholesky_ex(g + eps_big * eye, upper=True)
        r = torch.where(ok, r_small, r_big)
        return torch.linalg.solve_triangular(r, ys, upper=True, left=False)

    return one_round(one_round(one_round(y)))


def _thin_qr(y: torch.Tensor, qr_method: str = "householder") -> torch.Tensor:
    if qr_method == "cholesky":
        return _cholesky_qr2(y)
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
    if stabilize == "auto":
        stabilize = "always" if a.dtype == torch.float32 else "reference"
    if qr_method == "auto":
        qr_method = "cholesky" if stabilize == "always" else "householder"
    omega = _draw_sketch(key, (m, omega_rank), a.dtype, a.device)
    y = a @ omega
    for i in range(n_iter):
        if stabilize == "always" or i > 2:
            y = _thin_qr(y, qr_method)
        y = a @ (a.mT @ y)
        # guard: a zero panel (e.g. A == 0) must not produce 0/0 = NaN
        y = y / torch.linalg.vector_norm(y).clamp_min(1e-30)
    # the final orthonormalization sets B = Q^T A and every sigma after it:
    # exact Householder even on the cholesky fast path
    return _householder_qr(y)


def random_svd(a: torch.Tensor, omega_rank: int, n_iter: int,
               n_oversamples: int, key=0, stabilize: str = "auto",
               qr_method: str = "auto"):
    """Randomized SVD: A ~= U diag(s) Vt with U (n, r), s (r,), Vt (r, m).

    Parity with reference random_svd.rs:63-110, including the fat-matrix
    transpose path. ``key`` is an int seed or a ``torch.Generator``.
    """
    a = as_tensor(a)
    fat = a.shape[0] < a.shape[1]
    aa = a.mT if fat else a
    sketch_rank = min(omega_rank + n_oversamples, aa.shape[1])
    rank = min(omega_rank, sketch_rank)
    q = power_iter(aa, sketch_rank, n_iter, key=key, stabilize=stabilize,
                   qr_method=qr_method)
    u_b, s, vt = torch.linalg.svd(q.mT @ aa, full_matrices=False)
    return _truncate(q @ u_b, s, vt, rank, fat)


def _truncate(u, s, vt, rank: int, fat: bool):
    if fat:
        # A = V S (Q U_B)^T   since A^T ~= (Q U_B) S V^T
        return vt.mT[:, :rank], s[:rank], u.mT[:rank, :]
    return u[:, :rank], s[:rank], vt[:rank, :]


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
    k = min(rank + n_oversamples, m)
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

    Returns (U (n, rank), s (rank,), Vt (rank, m)) like ``random_svd``.
    """
    a = as_tensor(a)
    fat = a.shape[0] < a.shape[1]
    aa = a.mT if fat else a
    n, m = aa.shape
    k = min(rank + n_oversamples, m)
    if core_oversamples is None:
        ell = min(2 * k + 1, n)
    else:
        ell = min(k + int(core_oversamples), n)
    k_om, k_psi = _split_seed(key, 2, aa.device)
    omega = _draw_sketch(k_om, (m, k), aa.dtype, aa.device)
    psi = _draw_sketch(k_psi, (ell, n), aa.dtype, aa.device)
    y = aa @ omega                                      # pass 1: (n, k)
    w = psi @ aa                                        # pass 2: (ell, m)
    q = _householder_qr(y)                              # (n, k)
    # core: X = (Psi Q)^+ W by QR least squares; (ell, k) is small and
    # well conditioned w.h.p. for ell ~ 2k
    qb, rb = torch.linalg.qr(psi @ q, mode="reduced")
    x = torch.linalg.solve_triangular(rb, qb.mT @ w, upper=True)   # (k, m)
    u_x, s, vt = torch.linalg.svd(x, full_matrices=False)
    return _truncate(q @ u_x, s, vt, rank, fat)
