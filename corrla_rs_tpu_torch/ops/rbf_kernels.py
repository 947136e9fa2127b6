"""RBF kernel-matrix, streaming-matvec and modes-product kernels (CUDA) and
their plain versions.

The first two are counterparts of the two Pallas TPU kernels in
``corrla_rs_tpu/ops/pallas_kernels.py``; the CUDA C++ sources (sm_90a) are
``csrc/rbf_kernels.cu`` (kernel matrix), ``csrc/rbf_matvec.cuh`` (matvec)
and ``csrc/modes_product.cu`` (modes product), built on first use by
``ops._build``.

- ``pairwise_kernel_matrix(xa, xb, kernel, eps)`` replaces
  ``pallas_kernels.pairwise_kernel_matrix`` (``pallas_call`` at :100):
  K_ij = phi(||xa_i - xb_j||) as an (n_a, n_b) matrix;
  ``_pairwise_kernel_matrix_into(out, xa, xb, kernel, eps)`` writes it into
  a 2-D view whose rows lie ``out.stride(0) >= n_b`` apart (``rbf_fit``
  fills K's block of the saddle matrix with it). On the H100 it is bound by
  the store bandwidth of the n_a * n_b output (d is tiny). Persistent CTAs
  walk 64-row output tiles with the coordinates in registers, and store
  each tile by TMA from shared memory where the output's base and row
  stride are 16-byte aligned, else straight from registers with streaming
  stores (the kernel picks the path; ``_kmat_store_path`` reports it).
- ``rbf_matvec(x_query, x_support, coeffs, kernel, eps)`` replaces
  ``pallas_kernels.rbf_matvec_streaming`` (``pallas_call`` at :154):
  y_i = sum_j phi(||q_i - x_j||) c_j without forming the (M, N) matrix. On
  the H100 it is bound by instruction issue, about 2d + 8 + C FP32
  instructions a pair (7 of them the accurate sqrt, taken for a thread's
  four queries at once), and in f64 by the FP64 pipe (16 FP64 instructions
  a pair for the multiquadric at d=3, C=1, 8 of them the root). phi is
  taken from the squared distance: one root a pair for the multiquadric,
  none for the gaussian. Each thread keeps four queries in registers and
  their partial sums for a chunk of columns, and each packed support point
  (coordinates and coefficients, one 16-byte shared load at d=3, C=1)
  serves all four; support tiles stream through a ring of cp.async
  buffers. When the grid would underfill the card, the
  support is split over blocks and a second kernel adds the splits' partial
  sums in order (``_matvec_plan``). No atomics: reruns are bit-identical.
- ``modes_product(modes, w)`` is ``modes @ w.mT``, the field of
  ``PodI.predict``: sum_m modes[i, m] w[j, m] as an (n_pts, n_q) matrix. It
  replaces no TPU kernel (the JAX package leaves the product to XLA). For
  k <= 32 modes the product is bound by the stores of its output (2k
  operations an element, under the card's ridge), and the kernel writes it
  near the HBM rate (81% of it at 200,000 x 16,384 x 20 f32 on an H100,
  cuBLAS 44%): persistent CTAs, each thread's k weights in registers, a
  row's modes by broadcast shared loads, k FMAs an element in mode order,
  and the kernel matrix's two store paths (``_kmat_store_path`` reports
  either kernel's choice for an output). Both layouts of the modes go in
  without a copy. k > 32, bound by compute, and fewer than 80 queries,
  where cuBLAS is faster, go to ``torch.matmul``.

All take f32 or f64 (all operands of one dtype) and return that dtype.
Distances are direct differences, as the JAX XLA path computes them
(``interp.pairwise_dists``), not the Gram expansion of the Pallas kernels.

Each wrapper checks its operands, and then, for CUDA tensors, launches its
kernel on the current stream without synchronising and adds one to its
``launches`` count; a failed launch raises. For CPU tensors it runs the
plain PyTorch version (``pairwise_kernel_matrix_ref``, ``rbf_matvec_ref``,
``modes_product_ref``), which nothing on the CUDA path calls.

The kernels are also ``torch.library`` custom operators, registered when
this module is imported: ``corrla::pairwise_kernel_matrix``,
``corrla::pairwise_kernel_matrix_into`` (writes into ``out``),
``corrla::rbf_matvec`` and ``corrla::modes_product``. Each has the kernel's
launch as its CUDA implementation (the same C entry point and ``launches``
count), the plain version as its CPU implementation, and a fake
implementation for tracing (shapes and dtypes only); the kernel matrix with
phi = linear, the distance matrix, has the distance gradient of
``interp.pairwise_dists``, and the modes product the two plain products of
its gradient. A wrapper given CUDA tensors calls its operator while
``torch.export`` or ``torch.compile`` traces it
(``torch.compiler.is_compiling()``), so an exported program holds
``corrla.*`` nodes where the eager call launches the kernel, never the
plain version; eager CUDA calls launch directly, without the operator's
dispatch (the modes product takes its operator also where autograd records
a gradient). A process that loads such a program must have imported this
module first (``utils.export``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from corrla_rs_tpu_torch.ops._build import load_library

__all__ = [
    "pairwise_dists", "rbf_kernel_eval",
    "pairwise_kernel_matrix", "pairwise_kernel_matrix_ref",
    "rbf_matvec", "rbf_matvec_ref",
    "modes_product", "modes_product_ref",
]

# phi codes of csrc/rbf_kernels.cu
_PHI_CODES = {"linear": 1, "multiquadric": 2, "cubic": 3, "gaussian": 4}
_PHI_NAMES = {code: name for name, code in _PHI_CODES.items()}
# plain matvec: query rows per chunk so a chunk's kernel matrix holds at
# most this many elements
_REF_CHUNK_ELEMS = 1 << 26

# the matvec's launch shape (csrc/rbf_matvec.cuh): MV_THREADS x MV_QT
# queries a block, column chunks of one of _MV_COLS (by element size: f64
# has no 20-column instance); query blocks times chunks share gridDim.x
# (at most 2^31 - 1), splits lie on gridDim.z (at most 65535)
_MV_QUERIES_PER_BLOCK = 128 * 4
_MV_COLS = {4: (1, 2, 4, 8, 16, 20), 8: (1, 2, 4, 8, 16)}
_MV_MAX_GRID_YZ = 65535
# instruction slots a (query, support point) pair spends on its distance and
# phi, against one FMA a column: the price of one more column chunk
_MV_PAIR_COST = 12
# blocks an SM that the plan aims for before it splits the support
_MV_BLOCKS_PER_SM = 2
# the modes product's widest k on the kernel: up to it, 2k operations an
# element of 4 or 8 bytes stay under the card's ridge (20 operations a byte
# in f32, 10 in f64), so the stores bound the product; a wider one is bound
# by compute and goes to torch.matmul (csrc/modes_product.cu: MP_MAX_K)
_MODES_MAX_K = 32
# the modes product's fewest queries on the kernel: below it cuBLAS (gemv,
# then narrow GEMMs) beats the kernel, whose persistent grid of 160-row
# tiles costs about 0.05 ms whatever the width. The crossover on an H100 at
# 200,000 points, 20 modes, f32: 64 queries 0.050 ms against torch.matmul's
# 0.041, 80 queries 0.051 against 0.067 (32: 0.048 against 0.022)
_MODES_MIN_Q = 80


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
    first = dtype = device = None
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        if t.ndim != 2:
            raise ValueError(f"{name}: {arg} must be 2-D, got {tuple(t.shape)}")
        if t.shape[1] == 0:
            raise ValueError(f"{name}: {arg} has no columns")
        if t.dtype is not torch.float32 and t.dtype is not torch.float64:
            raise TypeError(f"{name}: {arg} must be float32 or float64")
        if first is None:
            first, dtype, device = t, t.dtype, t.device
        elif t.dtype is not dtype or t.device != device:
            raise ValueError(
                f"{name}: operands differ in dtype or device "
                f"({arg}: {t.dtype} on {t.device}, expected {dtype} "
                f"on {device})"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return first


def _raise_on_error(lib, name: str, rc: int) -> None:
    """Raise on a refused launch. The C side refuses what its grid or shared
    memory cannot take as invalid value: for the matvec more than 2^31 - 1
    query blocks times column chunks, or a feature dim above about 80 in f32
    and 40 in f64, where its queries no longer fit in shared memory; for the
    kernel matrix a row stride below n_b or an unknown phi."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed: "
                           f"{lib.corrla_error_string(rc).decode()} ({rc})")


def _suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


# C entry points by (name, dtype), resolved on first use
_ENTRIES: dict = {}


def _entry(name: str, dtype: torch.dtype):
    """The C entry point ``corrla_<name>_<f32|f64>``, resolved once."""
    fn = _ENTRIES.get((name, dtype))
    if fn is None:
        fn = _ENTRIES[(name, dtype)] = getattr(
            load_library(), f"corrla_{name}_{_suffix(dtype)}")
    return fn


def _launch(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on the current stream of ``device``, under
    ``torch.cuda.device`` only when that is not the current device."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _kmat_store_path(out: torch.Tensor) -> str:
    """``"tma"`` or ``"direct"``: how the kernel matrix stores into ``out``,
    a CUDA (n_a, n_b) view as ``_pairwise_kernel_matrix_into`` takes it. The
    kernel chooses by the output's address and row stride; this asks it."""
    tma = load_library().corrla_kernel_matrix_tma(
        out.data_ptr(), out.shape[0], out.shape[1], out.stride(0),
        out.element_size())
    return "tma" if tma else "direct"


def _kernel_matrix_operands(name: str, xa: torch.Tensor,
                            xb: torch.Tensor, kernel: str):
    """Checks shared by the kernel matrix's two entry points; returns
    (phi code, n_a, n_b, d)."""
    _check_operands(name, xa=xa, xb=xb)
    phi = _phi_code(kernel)
    (n_a, d), n_b = xa.shape, xb.shape[0]
    if xb.shape[1] != d:
        raise ValueError(f"{name}: feature dims {d} and {xb.shape[1]} differ")
    return phi, n_a, n_b, d


def _launch_kernel_matrix(out: torch.Tensor, xa: torch.Tensor,
                          xb: torch.Tensor, phi: int, eps: float) -> None:
    """One launch of the kernel into ``out`` (checked by the caller)."""
    (n_a, d), n_b = xa.shape, xb.shape[0]
    fn = _entry("kernel_matrix", out.dtype)
    rc = _launch(out.device, fn, xa.data_ptr(), xb.data_ptr(), out.data_ptr(),
                 n_a, n_b, d, out.stride(0), phi, float(eps))
    if rc:
        _raise_on_error(load_library(), "pairwise_kernel_matrix", rc)
    pairwise_kernel_matrix.launches += 1


def pairwise_kernel_matrix(xa: torch.Tensor, xb: torch.Tensor,
                           kernel: str = "linear",
                           eps: float = 1.0) -> torch.Tensor:
    """phi(||xa_i - xb_j||) as an (n_a, n_b) matrix, one fused kernel.

    xa (n_a, d), xb (n_b, d). CUDA tensors launch the kernel; CPU tensors
    run ``pairwise_kernel_matrix_ref``.
    """
    phi, n_a, n_b, _ = _kernel_matrix_operands("pairwise_kernel_matrix", xa,
                                               xb, kernel)
    if xa.device.type == "cpu":
        return pairwise_kernel_matrix_ref(xa, xb, kernel, eps)
    if torch.compiler.is_compiling():
        return torch.ops.corrla.pairwise_kernel_matrix(xa, xb, kernel,
                                                       float(eps))
    return _kernel_matrix_cuda(xa, xb, phi, n_a, n_b, eps)


pairwise_kernel_matrix.launches = 0


def _kernel_matrix_cuda(xa, xb, phi, n_a, n_b, eps):
    """The kernel matrix of checked CUDA operands into a new matrix (one
    launch unless it is empty)."""
    out = torch.empty((n_a, n_b), dtype=xa.dtype, device=xa.device)
    if out.numel():
        _launch_kernel_matrix(out, xa, xb, phi, eps)
    return out


def _pairwise_kernel_matrix_into(out: torch.Tensor, xa: torch.Tensor,
                                 xb: torch.Tensor, kernel: str = "linear",
                                 eps: float = 1.0) -> torch.Tensor:
    """``pairwise_kernel_matrix`` written into ``out``, an (n_a, n_b) view
    of xa's dtype and device with unit column stride and row stride
    ``>= n_b``, such as a block of a larger matrix; nothing outside the view
    is written, and ``out`` must not overlap xa or xb. Returns ``out``.

    CUDA tensors launch the kernel (one launch, counted in
    ``pairwise_kernel_matrix.launches``), which picks its store path from
    ``out``'s address and row stride (``_kmat_store_path``). CPU tensors
    copy ``pairwise_kernel_matrix_ref`` into the view.
    """
    phi = _check_into(out, xa, xb, kernel)
    if xa.device.type == "cpu":
        return out.copy_(pairwise_kernel_matrix_ref(xa, xb, kernel, eps))
    if torch.compiler.is_compiling():
        torch.ops.corrla.pairwise_kernel_matrix_into(out, xa, xb, kernel,
                                                     float(eps))
    elif out.numel():
        _launch_kernel_matrix(out, xa, xb, phi, eps)
    return out


def _check_into(out, xa, xb, kernel):
    """The checks of ``_pairwise_kernel_matrix_into``; returns phi's code."""
    name = "_pairwise_kernel_matrix_into"
    phi, n_a, n_b, _ = _kernel_matrix_operands(name, xa, xb, kernel)
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"{name}: out must be a tensor")
    if out.dtype != xa.dtype or out.device != xa.device:
        raise ValueError(f"{name}: out is {out.dtype} on {out.device}, "
                         f"expected {xa.dtype} on {xa.device}")
    if tuple(out.shape) != (n_a, n_b):
        raise ValueError(f"{name}: out has shape {tuple(out.shape)}, "
                         f"expected {(n_a, n_b)}")
    if out.numel() and (out.stride(1) != 1 or out.stride(0) < n_b):
        raise ValueError(f"{name}: out needs unit column stride and row "
                         f"stride >= {n_b}, got strides {out.stride()}")
    return phi


def rbf_matvec(x_query: torch.Tensor, x_support: torch.Tensor,
               coeffs: torch.Tensor, kernel: str = "linear",
               eps: float = 1.0) -> torch.Tensor:
    """sum_j phi(||q_i - x_j||) coeffs[j] without forming the (M, N) matrix.

    x_query (M, d), x_support (N, d), coeffs (N, C); returns (M, C). CUDA
    tensors launch the kernel (``_matvec_plan`` picks its launch shape, and
    a second, small kernel when it splits the support; ``launches`` counts
    one a call, and ``launches_by`` one a call under its instance's (dtype,
    kernel), e.g. ``(torch.float64, "multiquadric")``); CPU tensors run
    ``rbf_matvec_ref``.
    """
    first, phi = _matvec_operands(x_query, x_support, coeffs, kernel)
    if first.device.type == "cpu":
        return rbf_matvec_ref(x_query, x_support, coeffs, kernel, eps)
    if torch.compiler.is_compiling():
        return torch.ops.corrla.rbf_matvec(x_query, x_support, coeffs,
                                           kernel, float(eps))
    return _matvec_cuda(x_query, x_support, coeffs, phi, eps)


rbf_matvec.launches = 0
rbf_matvec.launches_by = {}


def _matvec_operands(x_query, x_support, coeffs, kernel):
    """Checks of the matvec's operands; returns (the first operand, phi's
    code)."""
    first = _check_operands("rbf_matvec", x_query=x_query,
                            x_support=x_support, coeffs=coeffs)
    phi = _phi_code(kernel)
    (n_q, d), n_s, n_c = x_query.shape, x_support.shape[0], coeffs.shape[1]
    if x_support.shape[1] != d or coeffs.shape[0] != n_s:
        raise ValueError(
            f"rbf_matvec: shapes {tuple(x_query.shape)}, "
            f"{tuple(x_support.shape)}, {tuple(coeffs.shape)} do not match"
        )
    return first, phi


def _matvec_cuda(x_query, x_support, coeffs, phi, eps):
    """The matvec of checked CUDA operands (one launch unless M or N is 0,
    which gives zeros)."""
    (n_q, d), n_s, n_c = x_query.shape, x_support.shape[0], coeffs.shape[1]
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
    fn = _entry("rbf_matvec", coeffs.dtype)
    rc = _launch(coeffs.device, fn, x_query.data_ptr(), x_support.data_ptr(),
                 coeffs.data_ptr(), out.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), n_q, n_s, d,
                 n_c, phi, float(eps), plan.cols, plan.splits, plan.split_len)
    if rc:
        _raise_on_error(load_library(), "rbf_matvec", rc)
    rbf_matvec.launches += 1
    key = (coeffs.dtype, _PHI_NAMES[phi])
    rbf_matvec.launches_by[key] = rbf_matvec.launches_by.get(key, 0) + 1
    return out


def modes_product_ref(modes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``modes_product``: ``modes @ w.mT``."""
    return modes @ w.mT


def _modes_operands(modes, w) -> None:
    """Checks of the modes product's operands: 2-D tensors of one dtype (f32
    or f64) on one CPU or CUDA device, (n_pts, k) and (n_q, k) with k >= 1,
    in any strides."""
    name = "modes_product"
    for arg, t in (("modes", modes), ("w", w)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        if t.ndim != 2:
            raise ValueError(f"{name}: {arg} must be 2-D, got {tuple(t.shape)}")
        if t.dtype is not torch.float32 and t.dtype is not torch.float64:
            raise TypeError(f"{name}: {arg} must be float32 or float64")
    if w.dtype is not modes.dtype or w.device != modes.device:
        raise ValueError(f"{name}: operands differ in dtype or device (w: "
                         f"{w.dtype} on {w.device}, modes: {modes.dtype} on "
                         f"{modes.device})")
    if modes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {modes.device}")
    if w.shape[1] != modes.shape[1] or modes.shape[1] == 0:
        raise ValueError(f"{name}: modes {tuple(modes.shape)} and w "
                         f"{tuple(w.shape)} need one k >= 1")


def modes_product(modes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``modes @ w.mT``: sum_m modes[i, m] w[j, m] as an (n_pts, n_q) matrix
    for modes (n_pts, k) and w (n_q, k), either in any strides.

    CPU tensors run ``modes_product_ref``. CUDA tensors with k <= 32 and
    at least 80 queries launch the kernel (``launches`` counts one a
    launch); with k > 32, bound by compute, or fewer queries, where
    cuBLAS is faster, they go to ``torch.matmul``. ``launches_by``
    counts the CUDA calls by (route, dtype, k), the route ``"kernel"`` or
    ``"matmul"``.
    """
    _modes_operands(modes, w)
    if modes.device.type == "cpu":
        return modes_product_ref(modes, w)
    if torch.compiler.is_compiling() or (
            torch.is_grad_enabled()
            and (modes.requires_grad or w.requires_grad)):
        return torch.ops.corrla.modes_product(modes, w)
    return _modes_product_cuda(modes, w)


modes_product.launches = 0
modes_product.launches_by = {}


def _modes_product_cuda(modes, w):
    """The modes product of checked CUDA operands on its route: one launch
    of the kernel for k <= 32 and n_q >= 80 (none for an empty output),
    else ``torch.matmul``."""
    k = modes.shape[1]
    if k > _MODES_MAX_K or w.shape[0] < _MODES_MIN_Q:
        out, route = modes @ w.mT, "matmul"
    else:
        out = torch.empty((modes.shape[0], w.shape[0]), dtype=modes.dtype,
                          device=modes.device)
        route = "kernel"
        if out.numel():
            _launch_modes_product(out, modes, w)
            modes_product.launches += 1
    key = (route, modes.dtype, k)
    modes_product.launches_by[key] = modes_product.launches_by.get(key, 0) + 1
    return out


def _launch_modes_product(out, modes, w):
    """One launch of the modes-product kernel into ``out``, a non-empty
    (n_pts, n_q) view of the operands' dtype and device with unit column
    stride and row stride ``>= n_q`` that overlaps neither operand; the
    kernel picks its store path from ``out`` as the kernel matrix's does
    (``_kmat_store_path``)."""
    fn = _entry("modes_product", out.dtype)
    rc = _launch(out.device, fn, modes.data_ptr(), w.data_ptr(),
                 out.data_ptr(), modes.shape[0], w.shape[0], modes.shape[1],
                 modes.stride(0), modes.stride(1), w.stride(0), w.stride(1),
                 out.stride(0))
    if rc:
        _raise_on_error(load_library(), "modes_product", rc)


# ---------------------------------------------------------------------------
# the kernels as torch.library custom operators

@torch.library.custom_op("corrla::pairwise_kernel_matrix", mutates_args=(),
                         device_types="cuda")
def _kmat_op(xa: torch.Tensor, xb: torch.Tensor, kernel: str,
             eps: float) -> torch.Tensor:
    phi, n_a, n_b, _ = _kernel_matrix_operands("pairwise_kernel_matrix", xa,
                                               xb, kernel)
    return _kernel_matrix_cuda(xa, xb, phi, n_a, n_b, eps)


@_kmat_op.register_kernel("cpu")
def _(xa, xb, kernel, eps):
    _kernel_matrix_operands("pairwise_kernel_matrix", xa, xb, kernel)
    return pairwise_kernel_matrix_ref(xa, xb, kernel, eps)


@_kmat_op.register_fake
def _(xa, xb, kernel, eps):
    _kernel_matrix_operands("pairwise_kernel_matrix", xa, xb, kernel)
    return xa.new_empty((xa.shape[0], xb.shape[0]))


def _kmat_setup(ctx, inputs, output):
    xa, xb, kernel, _ = inputs
    ctx.kernel = kernel
    ctx.save_for_backward(xa, xb, output)


def _dists_grad(grad, xa, xb, r, needs_input_grad):
    """(dxa, dxb) of the distance matrix r = ||xa_i - xb_j|| for the
    incoming gradient G: with W = G / R, zero where R = 0 (the subgradient
    of a distance at its minimum), dxa = rowsum(W) xa - W xb and dxb =
    colsum(W) xb - W^T xa; None where no gradient is needed."""
    live = r > 0
    w = torch.where(live, grad / torch.where(live, r, 1.0), 0.0)
    dxa = dxb = None
    if needs_input_grad[0]:
        dxa = w.sum(1, keepdim=True) * xa - w @ xb
    if needs_input_grad[1]:
        dxb = w.sum(0)[:, None] * xb - w.mT @ xa
    return dxa, dxb


def _kmat_backward(ctx, grad):
    """The distance matrix's gradient (phi = linear only)."""
    if ctx.kernel != "linear":
        raise RuntimeError(
            "corrla::pairwise_kernel_matrix: the gradient is defined for "
            f"kernel='linear' (the distance matrix), not {ctx.kernel!r}")
    return (*_dists_grad(grad, *ctx.saved_tensors, ctx.needs_input_grad),
            None, None)


_kmat_op.register_autograd(_kmat_backward, setup_context=_kmat_setup)


@torch.library.custom_op("corrla::pairwise_kernel_matrix_into",
                         mutates_args=("out",), device_types="cuda")
def _kmat_into_op(out: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
                  kernel: str, eps: float) -> None:
    phi = _check_into(out, xa, xb, kernel)
    if out.numel():
        _launch_kernel_matrix(out, xa, xb, phi, eps)


@_kmat_into_op.register_kernel("cpu")
def _(out, xa, xb, kernel, eps):
    _check_into(out, xa, xb, kernel)
    out.copy_(pairwise_kernel_matrix_ref(xa, xb, kernel, eps))


@_kmat_into_op.register_fake
def _(out, xa, xb, kernel, eps):
    _check_into(out, xa, xb, kernel)


@torch.library.custom_op("corrla::rbf_matvec", mutates_args=(),
                         device_types="cuda")
def _matvec_op(x_query: torch.Tensor, x_support: torch.Tensor,
               coeffs: torch.Tensor, kernel: str, eps: float) -> torch.Tensor:
    phi = _matvec_operands(x_query, x_support, coeffs, kernel)[1]
    return _matvec_cuda(x_query, x_support, coeffs, phi, eps)


@_matvec_op.register_kernel("cpu")
def _(x_query, x_support, coeffs, kernel, eps):
    _matvec_operands(x_query, x_support, coeffs, kernel)
    return rbf_matvec_ref(x_query, x_support, coeffs, kernel, eps)


@_matvec_op.register_fake
def _(x_query, x_support, coeffs, kernel, eps):
    _matvec_operands(x_query, x_support, coeffs, kernel)
    return coeffs.new_empty((x_query.shape[0], coeffs.shape[1]))


@torch.library.custom_op("corrla::modes_product", mutates_args=(),
                         device_types="cuda")
def _modes_op(modes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    _modes_operands(modes, w)
    return _modes_product_cuda(modes, w)


@_modes_op.register_kernel("cpu")
def _(modes, w):
    _modes_operands(modes, w)
    return modes_product_ref(modes, w)


@_modes_op.register_fake
def _(modes, w):
    _modes_operands(modes, w)
    return modes.new_empty((modes.shape[0], w.shape[0]))


def _modes_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _modes_backward(ctx, grad):
    """The plain products of the gradient: dmodes = G w, dw = G^T modes."""
    modes, w = ctx.saved_tensors
    return (grad @ w if ctx.needs_input_grad[0] else None,
            grad.mT @ modes if ctx.needs_input_grad[1] else None)


_modes_op.register_autograd(_modes_backward, setup_context=_modes_setup)
