"""Matrix utilities (counterpart of ``corrla_rs_tpu/ops/mat_utils.py``).

- eps-regularized Moore-Penrose pseudoinverse (reference mat_utils.rs:37-53)
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

import numpy as np
import torch

__all__ = [
    "pinv", "pinv_diag", "truncated_svd", "sort_evd", "col_means",
    "center_mat_col", "zcenter_mat_col", "mat_linspace", "mat_pinv_comp",
    "pinv_comp_parts", "complex_from_parts", "parts_from_complex",
    "apply_operator", "fd_derivative",
]


def pinv(a: torch.Tensor, eps: float = 1.0e-14) -> torch.Tensor:
    """Moore-Penrose pseudoinverse with eps-regularized singular values.

    Parity with reference mat_utils.rs:37-53: inverts every singular value
    as ``1 / (s + eps)`` (no rank cutoff), so exact-zero singular values are
    amplified to ``1/eps`` as in the reference. Batched over leading dims.
    """
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    s_inv = 1.0 / (s + eps)
    return (vh.mT * s_inv[..., None, :]) @ u.mT


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
