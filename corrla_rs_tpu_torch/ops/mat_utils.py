"""Matrix utilities of the slice (counterpart of ``corrla_rs_tpu/ops/mat_utils.py``).

- eps-regularized Moore-Penrose pseudoinverse (reference mat_utils.rs:37-53)
- column means and centering (reference mat_utils.rs:87-119, 482-499)

Matmul precision: the JAX package passes ``precision=HIGHEST`` to every
product; here TF32 is switched off once in ``utils.device``.
"""
from __future__ import annotations

import torch

__all__ = ["pinv", "col_means", "center_mat_col"]


def pinv(a: torch.Tensor, eps: float = 1.0e-14) -> torch.Tensor:
    """Moore-Penrose pseudoinverse with eps-regularized singular values.

    Parity with reference mat_utils.rs:37-53: inverts every singular value
    as ``1 / (s + eps)`` (no rank cutoff), so exact-zero singular values are
    amplified to ``1/eps`` as in the reference.
    """
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    s_inv = 1.0 / (s + eps)
    return (vh.mT * s_inv[None, :]) @ u.mT


def col_means(a: torch.Tensor) -> torch.Tensor:
    """Column means as a (1, n) row. Reference mat_utils.rs:87-119."""
    return a.mean(dim=0, keepdim=True)


def center_mat_col(a: torch.Tensor) -> torch.Tensor:
    """Subtract column means. Reference mat_utils.rs:482-499."""
    return a - col_means(a)
