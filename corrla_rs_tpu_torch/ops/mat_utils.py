"""Matrix utilities (counterpart of ``corrla_rs_tpu/ops/mat_utils.py``).

- eps-regularized Moore-Penrose pseudoinverse (reference mat_utils.rs:37-53),
  and the same pseudoinverse of a whole batch of small matrices at once
  (``pinv_batched``, a one-sided Jacobi SVD written as batched tensor
  operations: the local fits of ``models.active_subspaces``)
- diagonal pseudoinverse with zero cutoff (reference mat_utils.rs:386-402)
- truncated SVD (reference mat_utils.rs:74-83)
- descending eigen-decomposition sort (reference mat_utils.rs:459-478)
- column means, centering and z-scoring (reference mat_utils.rs:87-119,
  482-519)
- the reference's quirky ``mat_linspace`` (reference mat_utils.rs:600-610)
- complex pseudoinverses: ``mat_pinv_comp`` on the host, ``pinv_comp_parts``
  on the tensor's device (complex dtypes, which CUDA has)

Matmul precision: the JAX package passes ``precision=HIGHEST`` to every
product; here TF32 is switched off once in ``utils.device``.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from corrla_rs_tpu_torch.utils.tracing import annotate

__all__ = [
    "pinv", "pinv_batched", "pinv_diag", "truncated_svd", "sort_evd", "col_means",
    "center_mat_col", "zcenter_mat_col", "mat_linspace", "mat_pinv_comp",
    "pinv_comp_parts", "complex_from_parts", "parts_from_complex",
    "apply_operator", "fd_derivative",
]


def pinv(a: torch.Tensor, eps: float = 1.0e-14) -> torch.Tensor:
    """Moore-Penrose pseudoinverse with eps-regularized singular values.

    Parity with reference mat_utils.rs:37-53: inverts every singular value
    as ``1 / (s + eps)`` (no rank cutoff), so exact-zero singular values are
    amplified to ``1/eps`` as in the reference. Batched over leading dims.
    Under a ``torch.profiler`` profile the call is the span
    ``corrla.solve.pinv``.
    """
    with annotate("corrla.solve.pinv"):
        u, s, vh = torch.linalg.svd(a, full_matrices=False)
        s_inv = 1.0 / (s + eps)
        return (vh.mT * s_inv[..., None, :]) @ u.mT


# Batched one-sided Jacobi: sweeps run before the first read of the
# convergence measure, the most sweeps in all, and the measure's limit in
# units of the dtype's eps (LAPACK's gesvj stops at sqrt(rows) eps)
_JACOBI_BLIND_SWEEPS = 5
_JACOBI_MAX_SWEEPS = 40
_JACOBI_TOL_EPS = 16.0
# where the Jacobi beat the SVD loop on an H100 (tests/pinv_batched_bench.py
# --grid): its cost hardly moves with the batch below some thousand
# matrices, so it pays from about 120-670 matrices on (64 x 16 to 256 x 128)
# and never at 256 x 256; up to 32 x 32 torch runs cuSOLVER's batched SVD
BATCHED_PINV_MIN_BATCH = 1024
BATCHED_PINV_MAX_ROWS = 256
BATCHED_PINV_MAX_COLS = 128
BATCHED_SVD_MAX_DIM = 32


def _round_robin(n: int, device):
    """The n - 1 rounds of n / 2 disjoint pairs (n even) that meet every
    pair of 0..n-1 once: [(p_idx, q_idx)] as index tensors on ``device``."""
    rounds = []
    for r in range(n - 1):
        p, q = [r], [n - 1]
        for i in range(1, n // 2):
            p.append((r + i) % (n - 1))
            q.append((r - i) % (n - 1))
        rounds.append((torch.tensor(p, device=device),
                       torch.tensor(q, device=device)))
    return rounds


def _jacobi_sweep(w: torch.Tensor, m: int, rounds) -> torch.Tensor:
    """One sweep of Hestenes rotations over the rows of ``w`` (batch, n,
    m + n): the first m entries of row j are column j of A, the rest column
    j of V, and a rotation turns both alike. Returns the largest
    |a_p . a_q| / (|a_p| |a_q|) the sweep met, a 0-d tensor."""
    off = w.new_zeros(())
    for p, q in rounds:
        wp, wq = w[:, p], w[:, q]
        ap, aq = wp[..., :m], wq[..., :m]
        alpha = torch.sum(ap * ap, dim=-1)
        beta = torch.sum(aq * aq, dim=-1)
        gamma = torch.sum(ap * aq, dim=-1)
        scale = torch.sqrt(alpha) * torch.sqrt(beta)
        rot = (gamma != 0) & (scale > 0)
        off = torch.maximum(off, torch.where(
            rot, gamma.abs() / scale.clamp_min(1e-300), 0.0).amax())
        zeta = (beta - alpha) / (2.0 * torch.where(rot, gamma, 1.0))
        t = torch.where(zeta < 0, -1.0, 1.0) / (
            zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
        c = torch.rsqrt(1.0 + t * t)
        s = torch.where(rot, c * t, 0.0)[..., None]
        c = torch.where(rot, c, 1.0)[..., None]
        w[:, p] = c * wp - s * wq
        w[:, q] = s * wp + c * wq
    return off


def _complete_left_vectors(u: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """Unit left singular vectors for the exactly-zero singular values.

    ``u`` (batch, n, m) holds a left vector a row, zeros where ``zero``
    (batch, n) is set. Those rows are filled from a fixed full-rank matrix
    projected off the others, made orthonormal by a QR that leaves the rows
    already orthonormal as they are (up to rounding)."""
    b, n, m = u.shape
    fill = torch.randn((n, m), generator=torch.Generator().manual_seed(0),
                       dtype=torch.float64).to(device=u.device, dtype=u.dtype)
    fill = fill - (fill @ u.mT) @ u
    full = torch.where(zero[..., None], fill, u)
    q, r = torch.linalg.qr(full.mT)
    sign = torch.where(torch.diagonal(r, dim1=-2, dim2=-1) < 0, -1.0, 1.0)
    return torch.where(zero[..., None], (q * sign[..., None, :]).mT, u)


def pinv_batched(a: torch.Tensor, eps: float = 1.0e-14) -> torch.Tensor:
    """``pinv`` of every matrix of a batch of small matrices at once.

    Same semantics as ``pinv``: every singular value is inverted as
    ``1 / (s + eps)``, an exact zero included, whose left vector is then a
    unit vector of the left null space (which one is as arbitrary here as in
    LAPACK). The SVD is a one-sided (Hestenes) Jacobi over the whole
    (batch, rows, cols) block: a sweep is cols - 1 rounds of cols / 2
    disjoint column pairs, each round a few elementwise launches on all
    matrices; it is as accurate as LAPACK's ``gesvj``. On a GPU
    ``torch.linalg.svd`` of such a batch runs cuSOLVER once a matrix. The
    convergence measure is read once a sweep from the sixth sweep on, and
    the zero-column flag once at the end; nothing else synchronises. If the
    last sweep allowed still met columns above the limit, a RuntimeWarning
    says so.
    """
    lead, (m, n) = a.shape[:-2], a.shape[-2:]
    if m < n:
        return pinv_batched(a.mT, eps).mT
    n_even = n + n % 2      # an odd count plays against a zero column
    w = a.new_zeros((math.prod(lead), n_even, m + n_even))
    w[:, :n, :m] = a.reshape(-1, m, n).mT
    w[:, :, m:] = torch.eye(n_even, dtype=a.dtype, device=a.device)
    rounds = _round_robin(n_even, a.device)
    tol = _JACOBI_TOL_EPS * torch.finfo(a.dtype).eps
    for sweep in range(_JACOBI_MAX_SWEEPS):
        off = _jacobi_sweep(w, m, rounds)
        if sweep >= _JACOBI_BLIND_SWEEPS and float(off) <= tol:
            break
    else:
        off = float(off)
        if not off <= tol:
            warnings.warn(
                f"pinv_batched did not converge in {_JACOBI_MAX_SWEEPS} "
                f"sweeps: largest column cosine {off:.3e} above {tol:.3e}",
                RuntimeWarning, stacklevel=2)
    us, v = w[:, :n, :m], w[:, :n, m:m + n]
    s = torch.linalg.vector_norm(us, dim=-1)                    # (batch, n)
    zero = s == 0
    u = us / torch.where(zero, 1.0, s)[..., None]
    if bool(zero.any()):
        rows = torch.nonzero(zero.any(dim=-1))[:, 0]
        u[rows] = _complete_left_vectors(u[rows], zero[rows])
    out = (v * (1.0 / (s + eps))[..., None]).mT @ u
    return out.reshape(lead + (n, m))


def _jacobi_pays(shape, on_cuda: bool) -> bool:
    """Whether ``pinv_batched`` is the faster route for a block of this
    shape: on a GPU, where ``torch.linalg.svd`` runs once a matrix above
    32 x 32, from a thousand matrices of the sizes that were measured. On
    the CPU LAPACK's loop is the faster at every size tried."""
    cols, rows = sorted(shape[-2:])
    return (on_cuda and math.prod(shape[:-2]) >= BATCHED_PINV_MIN_BATCH
            and BATCHED_SVD_MAX_DIM < rows <= BATCHED_PINV_MAX_ROWS
            and cols <= BATCHED_PINV_MAX_COLS)


def _fit_pinv(a: torch.Tensor, eps: float = 1.0e-14) -> torch.Tensor:
    """``pinv`` for the polynomial fits: a large batch of small matrices on
    a GPU goes through ``pinv_batched``, anything else through ``pinv``."""
    if _jacobi_pays(a.shape, a.is_cuda):
        return pinv_batched(a, eps)
    return pinv(a, eps)


def pinv_diag(d_mat: torch.Tensor, eps: float = 1.0e-20) -> torch.Tensor:
    """Pseudoinverse of a diagonal matrix with zero cutoff.

    Parity with reference mat_utils.rs:386-402: entries with |d| < eps map
    to 0, else to ``1 / (d + eps)``.
    """
    d = torch.diagonal(d_mat)
    inv = torch.where(d.abs() < eps, torch.zeros_like(d), 1.0 / (d + eps))
    out = torch.zeros_like(d_mat)
    n = min(d_mat.shape)
    idx = torch.arange(n, device=d_mat.device)
    out[idx, idx] = inv[:n]
    return out


def truncated_svd(a: torch.Tensor, rank: int):
    """Exact truncated SVD: (U_r, s_r, Vt_r). Reference mat_utils.rs:74-83."""
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    return u[:, :rank], s[:rank], vh[:rank, :]


def sort_evd(eigs: torch.Tensor, eigvs: torch.Tensor):
    """Sort eigenvalues (descending) and reorder eigenvectors to match.

    Parity with reference mat_utils.rs:459-478: sorts by *value*
    descending (the reference's docstring says magnitude but its comparator
    is plain value order). ``eigs`` is (n,) or an (n, n) diagonal matrix,
    ``eigvs`` (m, n) with eigenvectors as columns. Returns
    (sorted_eigs_diag (n, n), sorted_eigvs (m, n)).
    """
    e = torch.diagonal(eigs) if eigs.ndim == 2 else eigs
    order = torch.argsort(-e, stable=True)
    return torch.diag(e[order]), eigvs[:, order]


def col_means(a: torch.Tensor) -> torch.Tensor:
    """Column means as a (1, n) row. Reference mat_utils.rs:87-119."""
    return a.mean(dim=0, keepdim=True)


def center_mat_col(a: torch.Tensor) -> torch.Tensor:
    """Subtract column means. Reference mat_utils.rs:482-499."""
    return a - col_means(a)


def zcenter_mat_col(a: torch.Tensor, ddof: int = 1) -> torch.Tensor:
    """Center columns to zero mean, unit std (sample std, ddof=1).
    Reference mat_utils.rs:503-519."""
    sd = torch.std(a, dim=0, keepdim=True, correction=ddof)
    return (a - col_means(a)) / sd


def mat_linspace(start: float, end: float, n_steps: int, dtype=None,
                 device=None) -> torch.Tensor:
    """(n_steps, 1) column of ``i * (end - start) / n_steps``.

    Deliberate parity with the reference quirk (mat_utils.rs:600-610): the
    ``start`` argument is ignored for the offset (values begin at 0) and the
    endpoint is excluded.
    """
    delta = (end - start) / n_steps
    dtype = dtype or torch.get_default_dtype()
    return (torch.arange(n_steps, dtype=dtype, device=device) * delta)[:, None]


def mat_pinv_comp(x, eps: float = 1.0e-16, mode: str = "reference"):
    """Complex Moore-Penrose pseudoinverse on the host (numpy).

    mode="reference": parity with reference mat_utils.rs:56-71, every
      singular value inverted as ``1 / (s + eps)`` (no rank cutoff).
    mode="cutoff": singular values below ``eps * s_max`` are zeroed (eps is
      a RELATIVE tolerance here, e.g. 1e-10); what DMDc uses.
    """
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    u, s, vh = np.linalg.svd(x, full_matrices=False)
    if mode == "reference":
        s_inv = 1.0 / (s + eps)
    elif mode == "cutoff":
        cutoff = eps * (s[0] if s.size else 1.0)
        s_inv = np.where(s > cutoff, 1.0 / np.maximum(s, 1e-300), 0.0)
    else:
        raise ValueError(f"unknown mode {mode!r} (use 'reference'|'cutoff')")
    return (vh.conj().T * s_inv[None, :]) @ u.conj().T


def pinv_comp_parts(x_re: torch.Tensor, x_im: torch.Tensor,
                    rtol: float | None = None):
    """Rank-cutoff complex pseudoinverse on the tensors' device.

    Same semantics as ``mat_pinv_comp(mode="cutoff")``: singular values
    below ``rtol * s_max`` are zeroed. rtol defaults by dtype: 1e-10 for
    f64, 1e-5 for f32 (junk directions sit at ~n eps s_max there). The
    JAX package embeds X in a real 2n x 2r matrix because its TPU has no
    complex dtype; here the SVD runs in complex arithmetic, which has the
    same singular values. Returns ``(p_re, p_im)`` of shape (r, n) for
    (n, r) parts; leading dims batch.
    """
    if rtol is None:
        rtol = 1.0e-10 if x_re.dtype == torch.float64 else 1.0e-5
    u, s, vh = torch.linalg.svd(torch.complex(x_re, x_im),
                                full_matrices=False)
    s_inv = torch.where(s > rtol * s[..., :1], 1.0 / s.clamp_min(1e-300),
                        torch.zeros_like(s))
    p = (vh.mH * s_inv[..., None, :].to(vh.dtype)) @ u.mH
    return p.real.contiguous(), p.imag.contiguous()


def complex_from_parts(re, im):
    """Join real/imag parts into a complex matrix. Reference mat_utils.rs:316-337."""
    return torch.complex(torch.as_tensor(re), torch.as_tensor(im))


def parts_from_complex(c: torch.Tensor):
    """Split a complex matrix into (re, im). Reference mat_utils.rs:316-337."""
    return c.real, c.imag


def apply_operator(a, block: torch.Tensor) -> torch.Tensor:
    """A @ block for an explicit matrix or a batched-matvec callable
    (n, k) -> (n, k): the library-wide matrix-free operator protocol."""
    if callable(a):
        return torch.as_tensor(a(block))
    return torch.as_tensor(a) @ block


def fd_derivative(x: torch.Tensor, dt: float) -> torch.Tensor:
    """2nd-order finite-difference d/dt along axis 0: centered interior,
    one-sided 2nd-order ends."""
    interior = (x[2:] - x[:-2]) / (2.0 * dt)
    first = (-3.0 * x[0] + 4.0 * x[1] - x[2]) / (2.0 * dt)
    last = (3.0 * x[-1] - 4.0 * x[-2] + x[-3]) / (2.0 * dt)
    return torch.cat([first[None], interior, last[None]], dim=0)
