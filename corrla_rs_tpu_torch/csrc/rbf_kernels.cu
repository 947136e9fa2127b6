// Hand-written Hopper (sm_90a) kernel for the RBF kernel matrix, and the
// error string of the port's plain C interface.
//
// It replaces the Pallas TPU kernel pairwise_kernel_matrix of the JAX
// package (corrla_rs_tpu/ops/pallas_kernels.py, pallas_call at :100):
//
//   corrla_kernel_matrix_{f32,f64}  K_ij = phi(||xa_i - xb_j||), (na, nb).
//
// The streaming matvec, which replaces rbf_matvec_streaming (pallas_call at
// :154), is in rbf_matvec.cuh (entry points rbf_matvec_f32.cu and
// rbf_matvec_f64.cu); each .cu file is compiled on its own, all at once.
//
// phi is a template parameter (rbf_common.cuh), and the kernel is
// instantiated for float and double. Distances are direct differences
// sum_k (a_k - b_k)^2 on the FMA pipes: the feature dimension d is tiny on
// this path (1 for POD's t, 2-10 for RbfInterp), so the Gram expansion
// a^2 + b^2 - 2ab buys nothing and would lose the exact zero on the
// diagonal.
//
// The ragged edges are masked, not padded: out-of-range rows load as 0 and
// are never stored. All offsets into global memory are 64-bit (na * nb
// passes 2^31 at about 46k x 46k).
//
// Plain C interface for ctypes: every entry point takes raw device pointers,
// int64 sizes, the phi code, eps and a cudaStream_t, launches on that stream
// without synchronising and returns cudaGetLastError() (0 on success). Sizes
// the grid cannot take return cudaErrorInvalidValue without a launch;
// corrla_error_string names a code.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "rbf_common.cuh"

namespace {

using namespace corrla;

// ---------------------------------------------------------------------------
// Kernel matrix. Bound by the store bandwidth of the na * nb output: each
// element costs about 3d flops plus phi, and d is tiny, so the design is
// about stores. One block per 64 x 64 output tile, 256 threads: threadIdx.x
// walks the 64 columns, so each warp stores 32 consecutive elements of a row
// (128 B for f32), and each thread keeps 16 rows' sums in registers. The xa
// and xb row tiles are staged in shared memory, 16 features at a time, xb
// transposed so that the column reads are conflict-free and the xa reads are
// warp broadcasts. Row tiles are on gridDim.x (up to 2^31 - 1), column tiles
// on gridDim.y (up to 65535, i.e. nb <= 4,194,240).
constexpr int KM_TILE = 64;
constexpr int KM_ROWS = 4;
constexpr int KM_PER = KM_TILE / KM_ROWS;
constexpr int KM_DK = 16;

template <typename T, int PHI>
__global__ void __launch_bounds__(KM_TILE * KM_ROWS)
kernel_matrix_kernel(const T* __restrict__ xa, const T* __restrict__ xb,
                     T* __restrict__ out, int64_t na, int64_t nb, int64_t d,
                     T eps) {
  __shared__ T sa[KM_TILE][KM_DK];
  __shared__ T sb[KM_DK][KM_TILE];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * KM_TILE + tx;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * KM_TILE;
  const int64_t col0 = static_cast<int64_t>(blockIdx.y) * KM_TILE;

  T acc[KM_PER];
#pragma unroll
  for (int i = 0; i < KM_PER; ++i) acc[i] = T(0);

  for (int64_t k0 = 0; k0 < d; k0 += KM_DK) {
    const int kc = static_cast<int>(d - k0 < KM_DK ? d - k0 : KM_DK);
    for (int idx = tid; idx < KM_TILE * KM_DK; idx += KM_TILE * KM_ROWS) {
      const int r = idx / KM_DK;
      const int k = idx % KM_DK;
      const int64_t ga = row0 + r;
      const int64_t gb = col0 + r;
      sa[r][k] = (ga < na && k < kc) ? xa[ga * d + k0 + k] : T(0);
      sb[k][r] = (gb < nb && k < kc) ? xb[gb * d + k0 + k] : T(0);
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      const T b = sb[k][tx];
#pragma unroll
      for (int i = 0; i < KM_PER; ++i) {
        const T diff = sa[ty + i * KM_ROWS][k] - b;
        acc[i] += diff * diff;
      }
    }
    __syncthreads();
  }

  const int64_t col = col0 + tx;
  if (col >= nb) return;
#pragma unroll
  for (int i = 0; i < KM_PER; ++i) {
    const int64_t row = row0 + ty + i * KM_ROWS;
    if (row < na) out[row * nb + col] = phi_of<T, PHI>(sqrt_t(acc[i]), eps);
  }
}

template <typename T, int PHI>
cudaError_t launch_kernel_matrix(const T* xa, const T* xb, T* out, int64_t na,
                                 int64_t nb, int64_t d, double eps,
                                 cudaStream_t stream) {
  const dim3 block(KM_TILE, KM_ROWS);
  const dim3 grid(static_cast<unsigned>((na + KM_TILE - 1) / KM_TILE),
                  static_cast<unsigned>((nb + KM_TILE - 1) / KM_TILE));
  kernel_matrix_kernel<T, PHI><<<grid, block, 0, stream>>>(
      xa, xb, out, na, nb, d, static_cast<T>(eps));
  return cudaGetLastError();
}

template <typename T>
int kernel_matrix(const void* xa, const void* xb, void* out, int64_t na,
                  int64_t nb, int64_t d, int64_t phi, double eps,
                  void* stream) {
  if (na <= 0 || nb <= 0 || d <= 0 ||
      (na + KM_TILE - 1) / KM_TILE > INT_MAX ||
      (nb + KM_TILE - 1) / KM_TILE > 65535) {
    return cudaErrorInvalidValue;
  }
  const T* a = static_cast<const T*>(xa);
  const T* b = static_cast<const T*>(xb);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phi) {
    case PHI_LINEAR:
      return launch_kernel_matrix<T, PHI_LINEAR>(a, b, o, na, nb, d, eps, s);
    case PHI_MULTIQUADRIC:
      return launch_kernel_matrix<T, PHI_MULTIQUADRIC>(a, b, o, na, nb, d, eps,
                                                       s);
    case PHI_CUBIC:
      return launch_kernel_matrix<T, PHI_CUBIC>(a, b, o, na, nb, d, eps, s);
    case PHI_GAUSSIAN:
      return launch_kernel_matrix<T, PHI_GAUSSIAN>(a, b, o, na, nb, d, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* corrla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int corrla_kernel_matrix_f32(const void* xa, const void* xb, void* out,
                             int64_t na, int64_t nb, int64_t d, int64_t phi,
                             double eps, void* stream) {
  return kernel_matrix<float>(xa, xb, out, na, nb, d, phi, eps, stream);
}

int corrla_kernel_matrix_f64(const void* xa, const void* xb, void* out,
                             int64_t na, int64_t nb, int64_t d, int64_t phi,
                             double eps, void* stream) {
  return kernel_matrix<double>(xa, xb, out, na, nb, d, phi, eps, stream);
}

}  // extern "C"
