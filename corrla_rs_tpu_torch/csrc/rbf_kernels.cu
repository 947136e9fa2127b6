// Hand-written Hopper (sm_90a) kernels for the RBF hot path.
//
// They replace the two Pallas TPU kernels of the JAX package,
// corrla_rs_tpu/ops/pallas_kernels.py:
//
//   corrla_kernel_matrix_{f32,f64}  <- pairwise_kernel_matrix (pallas_call at :100)
//       K_ij = phi(||xa_i - xb_j||), an (na, nb) matrix.
//   corrla_rbf_matvec_{f32,f64}     <- rbf_matvec_streaming (pallas_call at :154)
//       y_i = sum_j phi(||q_i - x_j||) c_j, (m, ncols), without forming the
//       (m, n) kernel matrix.
//
// phi is a compile-time template parameter with the codes of
// corrla_rs_tpu/ops/interp.py: 1 linear r, 2 multiquadric sqrt(1 + (eps r)^2),
// 3 cubic r^3, 4 gaussian exp(-(r eps)^2). Both kernels are instantiated for
// float and double. Distances are direct differences sum_k (a_k - b_k)^2 on
// the FMA pipes: the feature dimension d is tiny on this path (1 for POD's t,
// 2-10 for RbfInterp), so the Gram expansion a^2 + b^2 - 2ab buys nothing and
// would lose the exact zero on the diagonal. Math is the accurate sqrt/exp
// (no fast-math intrinsics).
//
// The ragged edges are masked, not padded: out-of-range rows load as 0 and
// are never stored; support points past n are never visited. All offsets
// into global memory are 64-bit (na * nb passes 2^31 at about 46k x 46k).
//
// Plain C interface for ctypes: every entry point takes raw device pointers,
// int64 sizes, the phi code, eps and a cudaStream_t, launches on that stream
// without synchronising and returns cudaGetLastError() (0 on success). Sizes
// the grid or shared memory cannot take return cudaErrorInvalidValue without
// a launch; corrla_error_string names a code.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int PHI_LINEAR = 1;
constexpr int PHI_MULTIQUADRIC = 2;
constexpr int PHI_CUBIC = 3;
constexpr int PHI_GAUSSIAN = 4;

__device__ __forceinline__ float sqrt_t(float v) { return sqrtf(v); }
__device__ __forceinline__ double sqrt_t(double v) { return sqrt(v); }
__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }

template <typename T, int PHI>
__device__ __forceinline__ T phi_of(T r, T eps) {
  if constexpr (PHI == PHI_LINEAR) {
    return r;
  } else if constexpr (PHI == PHI_CUBIC) {
    return r * r * r;
  } else if constexpr (PHI == PHI_MULTIQUADRIC) {
    const T er = eps * r;
    return sqrt_t(T(1) + er * er);
  } else {
    const T er = r * eps;
    return exp_t(-(er * er));
  }
}

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

// ---------------------------------------------------------------------------
// Streaming RBF matvec. Bound by FP32 (or FP64) FMA throughput: about
// m * n * (3d + phi + 2 ncols) flops against (m + n) d + n ncols + m ncols
// values read or written, so the design keeps everything per pair on chip.
// One block per 128 queries, one query per thread; the query coordinates sit
// in shared memory ([d][128], conflict-free). The block walks the support in
// tiles of 64 points, staging the x tile ([64][d]) and the coefficient tile
// ([64][CC]) in shared memory, where every thread reads the same address (a
// broadcast). Each thread keeps CC partial sums in registers; when ncols
// exceeds CC, gridDim.y covers the column chunks. There are no atomics and no
// split over the support: each y_i is summed in the order j = 0 .. n-1, so
// the result is deterministic.
constexpr int MV_Q = 128;
constexpr int MV_TN = 64;

template <typename T, int PHI, int CC>
__global__ void __launch_bounds__(MV_Q)
rbf_matvec_kernel(const T* __restrict__ q, const T* __restrict__ x,
                  const T* __restrict__ c, T* __restrict__ out, int64_t m,
                  int64_t n, int d, int64_t ncols, T eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sq = reinterpret_cast<T*>(smem_raw);  // [d][MV_Q]
  T* sx = sq + d * MV_Q;                   // [MV_TN][d]
  T* sc = sx + d * MV_TN;                  // [MV_TN][CC]

  const int t = threadIdx.x;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * MV_Q;
  const int64_t c0 = static_cast<int64_t>(blockIdx.y) * CC;
  const int cn = static_cast<int>(ncols - c0 < CC ? ncols - c0 : CC);

  for (int idx = t; idx < d * MV_Q; idx += MV_Q) {
    const int r = idx / d;
    const int k = idx % d;
    sq[k * MV_Q + r] = (q0 + r < m) ? q[(q0 + r) * d + k] : T(0);
  }

  T acc[CC];
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) acc[cc] = T(0);

  for (int64_t j0 = 0; j0 < n; j0 += MV_TN) {
    const int tn = static_cast<int>(n - j0 < MV_TN ? n - j0 : MV_TN);
    __syncthreads();  // the previous tile is consumed; sq is written
    for (int idx = t; idx < tn * d; idx += MV_Q) sx[idx] = x[j0 * d + idx];
    for (int idx = t; idx < MV_TN * CC; idx += MV_Q) {
      const int j = idx / CC;
      const int cc = idx % CC;
      sc[idx] = (j < tn && cc < cn) ? c[(j0 + j) * ncols + c0 + cc] : T(0);
    }
    __syncthreads();
    for (int j = 0; j < tn; ++j) {
      T d2 = T(0);
      for (int k = 0; k < d; ++k) {
        const T diff = sq[k * MV_Q + t] - sx[j * d + k];
        d2 += diff * diff;
      }
      const T ph = phi_of<T, PHI>(sqrt_t(d2), eps);
#pragma unroll
      for (int cc = 0; cc < CC; ++cc) acc[cc] += ph * sc[j * CC + cc];
    }
  }

  const int64_t row = q0 + t;
  if (row >= m) return;
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) {
    if (cc < cn) out[row * ncols + c0 + cc] = acc[cc];
  }
}

constexpr size_t kMaxDynamicSmem = 232448;  // 227 KB a block on sm_90
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T, int PHI, int CC>
cudaError_t launch_rbf_matvec(const T* q, const T* x, const T* c, T* out,
                              int64_t m, int64_t n, int64_t d, int64_t ncols,
                              double eps, cudaStream_t stream) {
  const size_t smem = sizeof(T) * static_cast<size_t>(
      d * MV_Q + d * MV_TN + MV_TN * CC);
  if (smem > kMaxDynamicSmem) return cudaErrorInvalidValue;
  auto kern = rbf_matvec_kernel<T, PHI, CC>;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(static_cast<unsigned>((m + MV_Q - 1) / MV_Q),
                  static_cast<unsigned>((ncols + CC - 1) / CC));
  kern<<<grid, MV_Q, smem, stream>>>(q, x, c, out, m, n, static_cast<int>(d),
                                     ncols, static_cast<T>(eps));
  return cudaGetLastError();
}

template <typename T, int PHI>
cudaError_t rbf_matvec_cols(const T* q, const T* x, const T* c, T* out,
                            int64_t m, int64_t n, int64_t d, int64_t ncols,
                            double eps, cudaStream_t s) {
  if (ncols <= 1) {
    return launch_rbf_matvec<T, PHI, 1>(q, x, c, out, m, n, d, ncols, eps, s);
  }
  if (ncols <= 8) {
    return launch_rbf_matvec<T, PHI, 8>(q, x, c, out, m, n, d, ncols, eps, s);
  }
  return launch_rbf_matvec<T, PHI, 32>(q, x, c, out, m, n, d, ncols, eps, s);
}

template <typename T>
int rbf_matvec(const void* q, const void* x, const void* c, void* out,
               int64_t m, int64_t n, int64_t d, int64_t ncols, int64_t phi,
               double eps, void* stream) {
  if (m <= 0 || n <= 0 || d <= 0 || ncols <= 0 ||
      (m + MV_Q - 1) / MV_Q > INT_MAX || (ncols + 31) / 32 > 65535) {
    return cudaErrorInvalidValue;
  }
  const T* qq = static_cast<const T*>(q);
  const T* xx = static_cast<const T*>(x);
  const T* cc = static_cast<const T*>(c);
  T* o = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phi) {
    case PHI_LINEAR:
      return rbf_matvec_cols<T, PHI_LINEAR>(qq, xx, cc, o, m, n, d, ncols, eps,
                                            s);
    case PHI_MULTIQUADRIC:
      return rbf_matvec_cols<T, PHI_MULTIQUADRIC>(qq, xx, cc, o, m, n, d,
                                                  ncols, eps, s);
    case PHI_CUBIC:
      return rbf_matvec_cols<T, PHI_CUBIC>(qq, xx, cc, o, m, n, d, ncols, eps,
                                           s);
    case PHI_GAUSSIAN:
      return rbf_matvec_cols<T, PHI_GAUSSIAN>(qq, xx, cc, o, m, n, d, ncols,
                                              eps, s);
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

int corrla_rbf_matvec_f32(const void* q, const void* x, const void* c,
                          void* out, int64_t m, int64_t n, int64_t d,
                          int64_t ncols, int64_t phi, double eps,
                          void* stream) {
  return rbf_matvec<float>(q, x, c, out, m, n, d, ncols, phi, eps, stream);
}

int corrla_rbf_matvec_f64(const void* q, const void* x, const void* c,
                          void* out, int64_t m, int64_t n, int64_t d,
                          int64_t ncols, int64_t phi, double eps,
                          void* stream) {
  return rbf_matvec<double>(q, x, c, out, m, n, d, ncols, phi, eps, stream);
}

}  // extern "C"
