"""Poly-augmented RBF interpolation.

Counterpart of ``corrla_rs_tpu/ops/interp.py`` (reference
interp_utils.rs:11-153, ``RbfInterp`` + 4 kernels). The two RBF steps run
through the port's CUDA kernels (``ops.rbf_kernels``) for CUDA tensors:

- ``rbf_fit`` allocates the saddle matrix [[K, P], [P^T, 0]] once, with
  rows padded to 128 bytes (``_padded_square``), has the kernel-matrix
  kernel write K = phi(pairwise_dists(x, x)) straight into its top-left
  block (``_pairwise_kernel_matrix_into``), and solves
  [[K, P], [P^T, 0]] c = [y; 0] for all right-hand-side columns at once. The
  JAX package concatenates the blocks, which XLA fuses; in eager PyTorch
  each concatenation would read and write K again;
- ``rbf_predict`` is ``rbf_matvec(xq, x, c[:n]) + P_q c[n:]``, which never
  forms the (n_query, n) kernel matrix.

``pairwise_dists`` is the routed distance matrix that the Gaussian processes
call: on CUDA tensors it launches the kernel-matrix kernel with phi = linear,
on CPU tensors it runs the plain ``rbf_kernels.pairwise_dists``. It is a
``torch.autograd.Function`` (``forward`` and ``setup_context`` apart, so that
``torch.func.grad`` and ``torch.func.vmap`` take it) whose backward is plain
PyTorch: with W = G / R, zero where R = 0, dxa = rowsum(W) xa - W xb and
dxb = colsum(W) xb - W^T xa. The JAX package's ``jax.grad`` of its
``pairwise_dists`` gives NaN at R = 0 (sqrt'(0) * 0); the port gives 0
there, the subgradient of a distance at its minimum (ROADMAP, Differences by
design).

Kernel-type integer codes match the pyo3 binding
(lib_math_utils_py.rs:187-193): 1=linear, 2=multiquadric, 3=cubic,
anything else=gaussian.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops import rbf_kernels
from corrla_rs_tpu_torch.ops.mat_utils import pinv
from corrla_rs_tpu_torch.ops.rbf_kernels import (
    _pairwise_kernel_matrix_into,
    rbf_kernel_eval,
    rbf_matvec,
)
from corrla_rs_tpu_torch.ops.stats_corr import build_full_vandermonde
from corrla_rs_tpu_torch.utils.device import as_tensor
from corrla_rs_tpu_torch.utils.tracing import annotate

__all__ = ["RbfInterp", "pairwise_dists", "rbf_kernel_eval", "rbf_fit",
           "rbf_predict"]

_KERNEL_NAMES = {1: "linear", 2: "multiquadric", 3: "cubic"}
# the saddle matrix's rows lie a multiple of this many bytes apart, so each
# row of K starts on a 128-byte line: with rows n + p wide, the kernel
# matrix's tile stores end in half-written 32-byte sectors and took 0.49
# against 0.36 ms at n = 16,384 on an H100 (tests/kmat_saddle_layout.py)
_SADDLE_ROW_BYTES = 128


class _PairwiseDists(torch.autograd.Function):
    """||xa_i - xb_j|| on the kernel-matrix kernel, with a plain backward."""

    @staticmethod
    def forward(xa, xb):
        if xa.device.type == "cpu":
            return rbf_kernels.pairwise_dists(xa, xb)
        return rbf_kernels.pairwise_kernel_matrix(xa.contiguous(),
                                                  xb.contiguous(), "linear")

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs, output)

    @staticmethod
    def backward(ctx, grad):
        return rbf_kernels._dists_grad(grad, *ctx.saved_tensors,
                                       ctx.needs_input_grad)

    @staticmethod
    def vmap(info, in_dims, xa, xb):
        # one call a batch member: the kernel takes 2-D operands
        xa, xb = (t.movedim(d, 0) if d is not None
                  else t.expand(info.batch_size, *t.shape)
                  for t, d in zip((xa, xb), in_dims))
        return torch.stack([_PairwiseDists.apply(a, b)
                            for a, b in zip(xa, xb)]), 0


def pairwise_dists(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix (n_a, n_b) of xa (n_a, d) and xb (n_b, d).

    CUDA tensors launch ``rbf_kernels.pairwise_kernel_matrix`` (phi =
    linear, counted in its ``launches``); CPU tensors run the plain
    ``rbf_kernels.pairwise_dists``. Differentiable in both operands (see the
    module docstring for the gradient at R = 0).
    """
    return _PairwiseDists.apply(xa, xb)


def _padded_square(size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """An uninitialised (size, size) matrix whose rows lie a multiple of
    ``_SADDLE_ROW_BYTES`` apart: the leading columns of a wider one."""
    step = _SADDLE_ROW_BYTES // dtype.itemsize
    ld = -(-size // step) * step
    return torch.empty((size, ld), dtype=dtype, device=device)[:, :size]


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

    Under a ``torch.profiler`` profile the LU solve is the span
    ``corrla.solve.saddle`` (``pinv`` opens ``corrla.solve.pinv`` itself).
    """
    x = x.contiguous()
    p_mat = build_full_vandermonde(x, poly_degree)
    n, p = p_mat.shape
    kp = _padded_square(n + p, x.dtype, x.device)
    _pairwise_kernel_matrix_into(kp[:n, :n], x, x, kernel, eps)
    kp[:n, n:] = p_mat
    kp[n:, :n] = p_mat.mT
    kp[n:, n:] = 0
    y_pad = y.new_zeros((n + p, y.shape[1]))
    y_pad[:n] = y
    if method == "pinv":
        return pinv(kp) @ y_pad
    with annotate("corrla.solve.saddle"):
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
