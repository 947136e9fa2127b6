"""RBF kernel-matrix and streaming-matvec kernels (CUDA) and their plain versions.

Counterparts of the two Pallas TPU kernels in
``corrla_rs_tpu/ops/pallas_kernels.py``; the CUDA C++ sources (sm_90a) are
``csrc/rbf_kernels.cu`` (kernel matrix) and ``csrc/rbf_matvec.cuh`` (matvec),
built on first use by ``ops._build``.

- ``pairwise_kernel_matrix(xa, xb, kernel, eps)`` replaces
  ``pallas_kernels.pairwise_kernel_matrix`` (``pallas_call`` at :100):
  K_ij = phi(||xa_i - xb_j||) as an (n_a, n_b) matrix. On the H100 it is
  bound by the store bandwidth of the n_a * n_b output (d is tiny). The
  kernel writes each 64 x 64 output tile once, with coalesced stores along
  n_b, from row tiles staged in shared memory.
- ``rbf_matvec(x_query, x_support, coeffs, kernel, eps)`` replaces
  ``pallas_kernels.rbf_matvec_streaming`` (``pallas_call`` at :154):
  y_i = sum_j phi(||q_i - x_j||) c_j without forming the (M, N) matrix. On
  the H100 it is bound by instruction issue, about 2d + 8 + C FP32
  instructions a pair (7 of them the accurate sqrt, taken for a thread's
  four queries at once). Each thread keeps four queries in registers and
  their partial sums for a chunk of columns, and each packed support point
  (coordinates and coefficients, one 16-byte shared load at d=3, C=1)
  serves all four; support tiles stream through a ring of cp.async
  buffers. When the grid would underfill the card, the
  support is split over blocks and a second kernel adds the splits' partial
  sums in order (``_matvec_plan``). No atomics: reruns are bit-identical.

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

from typing import NamedTuple

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

# the matvec's launch shape (csrc/rbf_matvec.cuh): MV_THREADS x MV_QT
# queries a block, column chunks of one of _MV_COLS (by element size: f64
# has no 20-column instance), at most 65535 chunks or splits
_MV_QUERIES_PER_BLOCK = 128 * 4
_MV_COLS = {4: (1, 2, 4, 8, 16, 20), 8: (1, 2, 4, 8, 16)}
_MV_MAX_GRID_YZ = 65535
# instruction slots a (query, support point) pair spends on its distance and
# phi, against one FMA a column: the price of one more column chunk
_MV_PAIR_COST = 12
# blocks an SM that the plan aims for before it splits the support
_MV_BLOCKS_PER_SM = 2


class MatvecPlan(NamedTuple):
    """Launch plan of the CUDA matvec: ``cols`` columns a thread (the
    instance), over ``col_chunks`` chunks; ``q_blocks`` query blocks;
    ``splits`` slices of the support of ``split_len`` points each (the last
    may hold fewer), summed in order by a second kernel when > 1."""
    cols: int
    col_chunks: int
    q_blocks: int
    splits: int
    split_len: int

    @property
    def blocks(self) -> int:
        return self.q_blocks * self.col_chunks * self.splits


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _matvec_plan(m: int, n: int, c: int, n_sms: int,
                 itemsize: int = 4) -> MatvecPlan:
    """Plan for ``m`` queries, ``n`` support points, ``c`` columns of
    ``itemsize``-byte floats on a card with ``n_sms`` SMs. A pure function of
    its arguments, so the result, which depends on the summation order, is
    the same run after run.

    The column instance minimises chunks x (pair cost + cols), the work a
    (query, support point) pair costs across all chunks. When the query
    blocks times the chunks are fewer than ``_MV_BLOCKS_PER_SM`` blocks an
    SM, the support is cut into equal splits of ``n // want`` points, which
    gives at least ``want`` splits, every one non-empty."""
    cols = min(_MV_COLS[itemsize],
               key=lambda k: (_cdiv(c, k) * (_MV_PAIR_COST + k), -k))
    chunks = _cdiv(c, cols)
    q_blocks = _cdiv(m, _MV_QUERIES_PER_BLOCK)
    target = _MV_BLOCKS_PER_SM * n_sms
    splits, split_len = 1, n
    if q_blocks * chunks < target:
        # splits of n // want points number fewer than 2 want: half the
        # grid's limit keeps them within it
        want = min(_cdiv(target, q_blocks * chunks), _MV_MAX_GRID_YZ // 2)
        split_len = max(1, n // want)
        splits = _cdiv(n, split_len)
    return MatvecPlan(cols, chunks, q_blocks, splits, split_len)


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    or, for the matvec, more than 1,310,700 columns in f32 and 1,048,560 in
    f64, or a feature dim above about 80 in f32 and 40 in f64, where its
    queries no longer fit in shared memory) as invalid value."""
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
    tensors launch the kernel (``_matvec_plan`` picks its launch shape, and
    a second, small kernel when it splits the support; ``launches`` counts
    one a call); CPU tensors run ``rbf_matvec_ref``.
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
    plan = _matvec_plan(n_q, n_s, n_c, _sm_count(coeffs.device),
                        coeffs.element_size())
    out = torch.empty((n_q, n_c), dtype=coeffs.dtype, device=coeffs.device)
    # the splits' partial sums; freed when this returns, which the caching
    # allocator orders after the kernels on this stream
    scratch = (torch.empty((plan.splits, n_c, n_q), dtype=coeffs.dtype,
                           device=coeffs.device) if plan.splits > 1 else None)
    lib = load_library()
    fn = getattr(lib, f"corrla_rbf_matvec_{_suffix(coeffs.dtype)}")
    with torch.cuda.device(coeffs.device):
        stream = torch.cuda.current_stream(coeffs.device).cuda_stream
        rc = fn(x_query.data_ptr(), x_support.data_ptr(), coeffs.data_ptr(),
                out.data_ptr(), None if scratch is None else scratch.data_ptr(),
                n_q, n_s, d, n_c, phi, float(eps), plan.cols, plan.splits,
                plan.split_len, stream)
    _raise_on_error(lib, "rbf_matvec", rc)
    rbf_matvec.launches += 1
    return out


rbf_matvec.launches = 0
