"""Poly-augmented RBF interpolation.

Counterpart of ``corrla_rs_tpu/ops/interp.py`` (reference
interp_utils.rs:11-153, ``RbfInterp`` + 4 kernels). The two RBF steps run
through the port's CUDA kernels (``ops.rbf_kernels``) for CUDA tensors:

- ``rbf_fit`` builds K = phi(pairwise_dists(x, x)) with
  ``pairwise_kernel_matrix`` and solves the saddle system
  [[K, P], [P^T, 0]] c = [y; 0] for all right-hand-side columns at once;
- ``rbf_predict`` is ``rbf_matvec(xq, x, c[:n]) + P_q c[n:]``, which never
  forms the (n_query, n) kernel matrix.

Kernel-type integer codes match the pyo3 binding
(lib_math_utils_py.rs:187-193): 1=linear, 2=multiquadric, 3=cubic,
anything else=gaussian.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops.mat_utils import pinv
from corrla_rs_tpu_torch.ops.rbf_kernels import (
    pairwise_dists,
    pairwise_kernel_matrix,
    rbf_kernel_eval,
    rbf_matvec,
)
from corrla_rs_tpu_torch.ops.stats_corr import build_full_vandermonde
from corrla_rs_tpu_torch.utils.device import as_tensor

__all__ = ["RbfInterp", "pairwise_dists", "rbf_kernel_eval", "rbf_fit",
           "rbf_predict"]

_KERNEL_NAMES = {1: "linear", 2: "multiquadric", 3: "cubic"}


def rbf_fit(x: torch.Tensor, y: torch.Tensor, kernel: str, eps: float,
            poly_degree: int, method: str = "solve") -> torch.Tensor:
    """Solve the poly-augmented RBF saddle system for coefficients.

    Block system [[K, P], [P^T, 0]] @ c = [y; 0], parity with
    interp_utils.rs:131-144. y (n, y_cols); returns (n + p, y_cols).

    method:
      - 'solve' (default): LU solve, backward stable (the saddle system is
        indefinite and ill-conditioned);
      - 'pinv': the reference's eps-regularized pseudoinverse
        (interp_utils.rs:139-142).
    """
    x = x.contiguous()
    k_mat = pairwise_kernel_matrix(x, x, kernel, eps)
    p_mat = build_full_vandermonde(x, poly_degree)
    p = p_mat.shape[1]
    kp = torch.cat([
        torch.cat([k_mat, p_mat], dim=1),
        torch.cat([p_mat.mT, p_mat.new_zeros((p, p))], dim=1),
    ], dim=0)
    y_pad = torch.cat([y, y.new_zeros((p, y.shape[1]))], dim=0)
    if method == "pinv":
        return pinv(kp) @ y_pad
    return torch.linalg.solve(kp, y_pad)


def rbf_predict(x_known: torch.Tensor, coeffs: torch.Tensor,
                x_query: torch.Tensor, kernel: str, eps: float,
                poly_degree: int) -> torch.Tensor:
    """Evaluate the fitted interpolant at query points. interp_utils.rs:146-153."""
    n = x_known.shape[0]
    p_q = build_full_vandermonde(x_query, poly_degree)
    k_part = rbf_matvec(x_query.contiguous(), x_known.contiguous(),
                        coeffs[:n].contiguous(), kernel, eps)
    return k_part + p_q @ coeffs[n:]


class RbfInterp:
    """RBF interpolator with polynomial augmentation.

    Signature mirrors PyRbfInterp (lib_math_utils_py.rs:186-198):
    ``RbfInterp(kernel_type, kernel_param, dim, poly_degree)`` where
    kernel_type is 1=linear, 2=multiquadric, 3=cubic, else gaussian, or a
    kernel name string. ``device`` is where numpy inputs to ``fit`` go
    (default: ``utils.device.default_device()``); tensors stay where they
    are. Query points are moved to the fitted state's device and dtype.
    """

    def __init__(self, kernel_type=1, kernel_param: float = 1.0, dim: int = 1,
                 poly_degree: int = 1, method: str = "solve", device=None):
        if isinstance(kernel_type, str):
            self.kernel = kernel_type
        else:
            self.kernel = _KERNEL_NAMES.get(int(kernel_type), "gaussian")
        self.eps = float(kernel_param)
        self.rbf_dim = int(dim)
        self.poly_degree = int(poly_degree)
        self.method = method
        self._device = device
        self.x_known = None
        self.coeffs = None

    def _check_dim(self, x: torch.Tensor) -> None:
        if x.ndim != 2 or x.shape[1] != self.rbf_dim:
            raise ValueError(
                f"expected (n, {self.rbf_dim}) points, got {tuple(x.shape)}"
            )

    def fit(self, x_in, y_in):
        x = as_tensor(x_in, device=self._device)
        y = as_tensor(y_in, device=x.device, dtype=x.dtype)
        if y.ndim == 1:
            y = y[:, None]
        self._check_dim(x)
        self.x_known = x
        self.coeffs = rbf_fit(x, y, self.kernel, self.eps, self.poly_degree,
                              self.method)
        return self

    def predict(self, x_query) -> torch.Tensor:
        xq = as_tensor(x_query, device=self.x_known.device,
                       dtype=self.x_known.dtype)
        self._check_dim(xq)
        return rbf_predict(self.x_known, self.coeffs, xq, self.kernel,
                           self.eps, self.poly_degree)
