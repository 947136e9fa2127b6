"""RBF kernel-matrix and streaming-matvec kernels (CUDA) and their plain versions.

Counterparts of the two Pallas TPU kernels in
``corrla_rs_tpu/ops/pallas_kernels.py``; the CUDA C++ sources are in
``csrc/rbf_kernels.cu`` (sm_90a), built on first use by ``ops._build``.

- ``pairwise_kernel_matrix(xa, xb, kernel, eps)`` replaces
  ``pallas_kernels.pairwise_kernel_matrix`` (``pallas_call`` at :100):
  K_ij = phi(||xa_i - xb_j||) as an (n_a, n_b) matrix. On the H100 it is
  bound by the store bandwidth of the n_a * n_b output (d is tiny). The
  kernel writes each 64 x 64 output tile once, with coalesced stores along
  n_b, from row tiles staged in shared memory.
- ``rbf_matvec(x_query, x_support, coeffs, kernel, eps)`` replaces
  ``pallas_kernels.rbf_matvec_streaming`` (``pallas_call`` at :154):
  y_i = sum_j phi(||q_i - x_j||) c_j without forming the (M, N) matrix. On
  the H100 it is bound by FMA throughput, about M N (3d + phi + 2C) flops.
  Each thread owns one query and keeps its C partial sums in registers
  while the block streams support tiles through shared memory; the sum runs
  in support order, with no atomics, so it is deterministic.

Both take f32 or f64 (all operands of one dtype) and return that dtype.
Distances are direct differences, as the JAX XLA path computes them
(``interp.pairwise_dists``), not the Gram expansion of the Pallas kernels.

Each wrapper checks its operands, and then, for CUDA tensors, launches its
kernel on the current stream without synchronising and adds one to its
``launches`` count; a failed launch raises. For CPU tensors it runs the
plain PyTorch version (``pairwise_kernel_matrix_ref``, ``rbf_matvec_ref``),
which nothing on the CUDA path calls.
"""
from __future__ import annotations

import torch

from corrla_rs_tpu_torch.ops._build import load_library

__all__ = [
    "pairwise_dists", "rbf_kernel_eval",
    "pairwise_kernel_matrix", "pairwise_kernel_matrix_ref",
    "rbf_matvec", "rbf_matvec_ref",
]

# phi codes of csrc/rbf_kernels.cu
_PHI_CODES = {"linear": 1, "multiquadric": 2, "cubic": 3, "gaussian": 4}
# plain matvec: query rows per chunk so a chunk's kernel matrix holds at
# most this many elements
_REF_CHUNK_ELEMS = 1 << 26


def pairwise_dists(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix (n_a, n_b) from direct differences.

    Accumulates one feature at a time, so no (n_a, n_b, d) array is formed.
    """
    d2 = torch.zeros((xa.shape[0], xb.shape[0]), dtype=xa.dtype,
                     device=xa.device)
    for k in range(xa.shape[1]):
        diff = xa[:, k, None] - xb[None, :, k]
        d2 += diff * diff
    return torch.sqrt(d2)


def rbf_kernel_eval(r: torch.Tensor, kernel: str, eps: float) -> torch.Tensor:
    """RBF kernel on distances (interp_utils.rs:31-80): linear r, cubic r^3,
    multiquadric sqrt(1 + (eps r)^2), gaussian exp(-(eps r)^2)."""
    if kernel == "linear":
        return r
    if kernel == "cubic":
        return r * r * r
    if kernel == "multiquadric":
        return torch.sqrt(1.0 + (eps * r) ** 2)
    if kernel == "gaussian":
        return torch.exp(-((r * eps) ** 2))
    raise ValueError(f"unknown RBF kernel: {kernel!r}")


def pairwise_kernel_matrix_ref(xa: torch.Tensor, xb: torch.Tensor,
                               kernel: str = "linear",
                               eps: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of ``pairwise_kernel_matrix``."""
    return rbf_kernel_eval(pairwise_dists(xa, xb), kernel, eps)


def rbf_matvec_ref(x_query: torch.Tensor, x_support: torch.Tensor,
                   coeffs: torch.Tensor, kernel: str = "linear",
                   eps: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of ``rbf_matvec``: the kernel matrix times the
    coefficients, formed a block of query rows at a time."""
    n_q, n_s = x_query.shape[0], x_support.shape[0]
    out = torch.empty((n_q, coeffs.shape[1]), dtype=coeffs.dtype,
                      device=coeffs.device)
    rows = max(1, _REF_CHUNK_ELEMS // max(1, n_s))
    for i in range(0, n_q, rows):
        k = pairwise_kernel_matrix_ref(x_query[i:i + rows], x_support,
                                       kernel, eps)
        out[i:i + rows] = k @ coeffs
    return out


def _phi_code(kernel: str) -> int:
    try:
        return _PHI_CODES[kernel]
    except KeyError:
        raise ValueError(f"unknown RBF kernel: {kernel!r}") from None


def _check_operands(name: str, **tensors: torch.Tensor) -> torch.Tensor:
    """Same device and dtype (f32/f64), 2-D and contiguous; returns the
    first operand."""
    first = next(iter(tensors.values()))
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        if t.ndim != 2:
            raise ValueError(f"{name}: {arg} must be 2-D, got {tuple(t.shape)}")
        if t.shape[1] == 0:
            raise ValueError(f"{name}: {arg} has no columns")
        if t.dtype not in (torch.float32, torch.float64):
            raise TypeError(f"{name}: {arg} must be float32 or float64")
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(
                f"{name}: operands differ in dtype or device "
                f"({arg}: {t.dtype} on {t.device}, expected {first.dtype} "
                f"on {first.device})"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")
    return first


def _raise_on_error(lib, name: str, rc: int) -> None:
    """Raise on a refused launch. The C side refuses sizes its grid or
    shared memory cannot take (e.g. n_b > 4,194,240 for the kernel matrix,
    or a feature dim too large for the matvec's tiles) as invalid value."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed: "
                           f"{lib.corrla_error_string(rc).decode()} ({rc})")


def _suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def pairwise_kernel_matrix(xa: torch.Tensor, xb: torch.Tensor,
                           kernel: str = "linear",
                           eps: float = 1.0) -> torch.Tensor:
    """phi(||xa_i - xb_j||) as an (n_a, n_b) matrix, one fused kernel.

    xa (n_a, d), xb (n_b, d). CUDA tensors launch the kernel; CPU tensors
    run ``pairwise_kernel_matrix_ref``.
    """
    first = _check_operands("pairwise_kernel_matrix", xa=xa, xb=xb)
    phi = _phi_code(kernel)
    (n_a, d), n_b = xa.shape, xb.shape[0]
    if xb.shape[1] != d:
        raise ValueError(f"pairwise_kernel_matrix: feature dims {d} and "
                         f"{xb.shape[1]} differ")
    if first.device.type == "cpu":
        return pairwise_kernel_matrix_ref(xa, xb, kernel, eps)
    out = torch.empty((n_a, n_b), dtype=xa.dtype, device=xa.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    fn = getattr(lib, f"corrla_kernel_matrix_{_suffix(xa.dtype)}")
    with torch.cuda.device(xa.device):
        stream = torch.cuda.current_stream(xa.device).cuda_stream
        rc = fn(xa.data_ptr(), xb.data_ptr(), out.data_ptr(), n_a, n_b, d,
                phi, float(eps), stream)
    _raise_on_error(lib, "pairwise_kernel_matrix", rc)
    pairwise_kernel_matrix.launches += 1
    return out


pairwise_kernel_matrix.launches = 0


def rbf_matvec(x_query: torch.Tensor, x_support: torch.Tensor,
               coeffs: torch.Tensor, kernel: str = "linear",
               eps: float = 1.0) -> torch.Tensor:
    """sum_j phi(||q_i - x_j||) coeffs[j] without forming the (M, N) matrix.

    x_query (M, d), x_support (N, d), coeffs (N, C); returns (M, C). CUDA
    tensors launch the kernel; CPU tensors run ``rbf_matvec_ref``.
    """
    first = _check_operands("rbf_matvec", x_query=x_query,
                            x_support=x_support, coeffs=coeffs)
    phi = _phi_code(kernel)
    (n_q, d), n_s, n_c = x_query.shape, x_support.shape[0], coeffs.shape[1]
    if x_support.shape[1] != d or coeffs.shape[0] != n_s:
        raise ValueError(
            f"rbf_matvec: shapes {tuple(x_query.shape)}, "
            f"{tuple(x_support.shape)}, {tuple(coeffs.shape)} do not match"
        )
    if first.device.type == "cpu":
        return rbf_matvec_ref(x_query, x_support, coeffs, kernel, eps)
    if n_q == 0 or n_s == 0:
        return torch.zeros((n_q, n_c), dtype=coeffs.dtype,
                           device=coeffs.device)
    out = torch.empty((n_q, n_c), dtype=coeffs.dtype, device=coeffs.device)
    lib = load_library()
    fn = getattr(lib, f"corrla_rbf_matvec_{_suffix(coeffs.dtype)}")
    with torch.cuda.device(coeffs.device):
        stream = torch.cuda.current_stream(coeffs.device).cuda_stream
        rc = fn(x_query.data_ptr(), x_support.data_ptr(), coeffs.data_ptr(),
                out.data_ptr(), n_q, n_s, d, n_c, phi, float(eps), stream)
    _raise_on_error(lib, "rbf_matvec", rc)
    rbf_matvec.launches += 1
    return out


rbf_matvec.launches = 0
