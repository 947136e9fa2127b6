// Hand-written Hopper (sm_90a) kernel for the RBF kernel matrix, and the
// error string of the port's plain C interface.
//
// It replaces the Pallas TPU kernel pairwise_kernel_matrix of the JAX
// package (corrla_rs_tpu/ops/pallas_kernels.py, pallas_call at :100):
//
//   corrla_kernel_matrix_{f32,f64}
//     out[i * ldo + j] = phi(||xa_i - xb_j||),  i < na, j < nb, ldo >= nb,
//
// an (na, nb) view whose rows lie ldo elements apart: a matrix of its own,
// or a block of a larger one such as the RBF saddle matrix [[K, P], [P^T,
// 0]], which the caller fills without a copy.
//
// The streaming matvec, which replaces rbf_matvec_streaming (pallas_call at
// :154), is in rbf_matvec.cuh (entry points rbf_matvec_f32.cu and
// rbf_matvec_f64.cu); each .cu file is compiled on its own, all at once.
//
// Contract. f32 and f64, the four phi of rbf_common.cuh, accurate sqrt and
// exp. Distances are direct differences, sum_k (a_k - b_k)^2 summed in
// feature order with one FMA a feature, then sqrtf's (or sqrt's) correctly
// rounded root: K_ii is exactly phi(0), and an element's bits depend only on
// its two rows, never on the tile, the grid or the store path, so reruns are
// bit-identical. No Gram expansion a^2 + b^2 - 2ab and no tensor cores: d is
// at most 8 on every caller (1 for POD's t, 3 for RbfInterp in 3-D, 8 for
// the kNN of active_ss), where the Gram form buys nothing and would lose the
// exact zero. Ragged edges are masked, not padded, and global offsets are
// 64-bit.
//
// What bounds it on an H100: the bytes of the output, 4 or 8 a pair, against
// 2d + 8 f32 instructions a pair for the distance and the root, so loads,
// math and stores must overlap. With the design below it runs at 93-94% of
// the bytes bound at d = 3 (f32 and f64); at d = 8 the instruction rate
// sets the time, at 76-80% of that bound (chip_smoke.py's kernel table).
// The design:
//
//   1. Persistent tiles. The grid is the CTAs an SM can hold times the SMs
//      (capped by the tile count), and each CTA walks output tiles of
//      KM_TM x km_tn rows x columns (64 x 128 f32, 64 x 64 f64: a warp's row
//      is 512 bytes) in row-major order, t = blockIdx.x, += gridDim.x. The
//      inputs ((na + nb) d elements, 393 KB at 16384^2, d = 3) stay in L2;
//      the CTAs in flight share a few xa row tiles and all of xb.
//   2. Coordinates in registers. d = 1..8 is a template parameter D. While
//      a tile is computed, the next tile's xa rows and xb columns arrive by
//      cp.async in the other of two stages. Each thread owns KM_RPW rows x
//      VEC consecutive columns (4 f32, 2 f64) of a tile. Its columns' D
//      coordinates sit in registers for the whole tile, and a row's come
//      from one broadcast 16-byte shared load per VEC features, so a
//      feature costs an FADD and an FFMA per element. d > 8 (D = 0) stages
//      16-feature slabs in shared memory instead, as a runtime loop.
//   3. Square roots go through sqrt_n (rbf_common.cuh), KM_RB rows' KM_RB x
//      VEC at once: sqrtf's bits, with the chains interleaved.
//   4. Stores, two paths of this kernel (tile_store.cuh), chosen here from
//      the output's address and shape (tma_store_fits;
//      corrla_kernel_matrix_tma reports the choice):
//      - TMA: each finished tile goes to one of two shared buffers, and one
//        thread stores it with cp.async.bulk.tensor (evict-first L2 hint),
//        which clips the ragged edge; the store of one tile overlaps the
//        computing of the next. The tensor map comes from
//        cuTensorMapEncodeTiled, reached through the runtime's entry-point
//        query, so the library needs no -lcuda. TMA needs a 16-byte-
//        aligned base and row stride, and int32 coordinates.
//      - Direct: where those do not hold (nb = 2001 in f32, PodI's saddle
//        matrix, 2002 floats wide, a view at an odd offset), each thread
//        stores its VEC values straight from registers with st.global.cs:
//        16 bytes where the address is aligned and every column is in
//        range, two 8-byte halves (f32) where it is 8-byte aligned, single
//        elements otherwise.
//
// Plain C interface for ctypes: every entry point takes raw device pointers,
// int64 sizes, the phi code, eps and a cudaStream_t, launches on that stream
// without synchronising and returns cudaGetLastError() (0 on success).
// Arguments it cannot take (ldo < nb, an unknown phi) return
// cudaErrorInvalidValue without a launch; corrla_error_string names a code.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "rbf_common.cuh"
#include "tile_store.cuh"

namespace {

using namespace corrla;

constexpr int KM_WARPS = 8;
constexpr int KM_THREADS = KM_WARPS * 32;
constexpr int KM_TM = 64;                  // tile rows
constexpr int KM_RPW = KM_TM / KM_WARPS;   // rows a warp
constexpr int KM_RB = 2;                   // rows a thread finishes at once
constexpr int KM_DK = 16;                  // features a slab (d > 8)
constexpr int KM_SMEM_ALIGN = 128;         // a TMA source's alignment

// tile columns: a warp's 32 threads x 16 bytes
template <typename T>
__host__ __device__ constexpr int km_tn() {
  return 32 * vec_elems<T>();
}

// xa row stride within a stage, and the elements of one stage: D > 0 holds
// the tile's xa rows [KM_TM][pd] and xb columns transposed [D][km_tn]; D = 0
// one slab of KM_DK features of each
template <typename T>
__host__ __device__ constexpr int km_pd(int D) {
  return D > 0 ? static_cast<int>(round_up(D, vec_elems<T>())) : KM_DK;
}

template <typename T>
__host__ __device__ constexpr int km_stage_elems(int D) {
  return KM_TM * km_pd<T>(D) + (D > 0 ? D : KM_DK) * km_tn<T>();
}

// dynamic shared memory of a CTA: alignment slack, the two output tiles
// (TMA path only), the coordinate stages (two for D > 0, one slab for D = 0)
template <typename T>
size_t km_smem_bytes(int D, bool tma) {
  const size_t out = tma ? 2 * KM_TM * km_tn<T>() : 0;
  const size_t stages = static_cast<size_t>(D > 0 ? 2 : 1) *
                        static_cast<size_t>(km_stage_elems<T>(D));
  return KM_SMEM_ALIGN + sizeof(T) * (out + stages);
}

template <typename T>
struct KmArgs {
  const T* xa;
  const T* xb;
  T* out;
  int64_t na, nb, d, ldo;
  int64_t col_tiles, tiles;
  T eps;
  int tma;
};

// ---------------------------------------------------------------------------
// the tile's pieces

// phi of KM_RB rows' KM_RB x VEC squared distances (rows lr, lr + 1, ...),
// then into the shared tile (TMA) or straight to the output (direct)
template <typename T, int PHI>
__device__ __forceinline__ void finish_rows(T (&r)[KM_RB * vec_elems<T>()],
                                            const KmArgs<T>& a, T* ob,
                                            int lr, int col_l, int64_t row0,
                                            int64_t col0) {
  constexpr int VEC = vec_elems<T>();
  sqrt_n(r);
#pragma unroll
  for (int i = 0; i < KM_RB * VEC; ++i) r[i] = phi_of<T, PHI>(r[i], a.eps);
#pragma unroll
  for (int h = 0; h < KM_RB; ++h) {
    if (a.tma) {
      store16(ob + (lr + h) * km_tn<T>() + col_l, r + h * VEC);
    } else {
      const int64_t row = row0 + lr + h;
      const int64_t col = col0 + col_l;
      if (row < a.na && col < a.nb) {
        const int64_t left = a.nb - col;
        store_direct(a.out + row * a.ldo + col, r + h * VEC,
                     left < VEC ? static_cast<int>(left) : VEC);
      }
    }
  }
}

// D > 0: copy the tile's xa rows and xb columns into a stage by cp.async,
// zeros past the ragged edges and in the padding of a row
template <typename T, int D>
__device__ __forceinline__ void stage_coords(T* st, const KmArgs<T>& a,
                                             int64_t row0, int64_t col0) {
  constexpr int TN = km_tn<T>();
  constexpr int PD = km_pd<T>(D);
  T* sa = st;
  T* sb = st + KM_TM * PD;
  for (int idx = threadIdx.x; idx < KM_TM * PD; idx += KM_THREADS) {
    const int r = idx / PD;
    const int k = idx - r * PD;
    const int64_t g = row0 + r;
    const bool ok = k < D && g < a.na;
    cp_async_zfill<sizeof(T)>(sa + idx, ok ? a.xa + g * D + k : a.xa, ok);
  }
  for (int idx = threadIdx.x; idx < D * TN; idx += KM_THREADS) {
    const int k = idx / TN;
    const int c = idx - k * TN;
    const int64_t g = col0 + c;
    const bool ok = g < a.nb;
    cp_async_zfill<sizeof(T)>(sb + idx, ok ? a.xb + g * D + k : a.xb, ok);
  }
}

// D > 0: rows lr .. lr + KM_RB - 1 of the tile from a landed stage, against
// this thread's columns, whose coordinates bc are in registers
template <typename T, int PHI, int D>
__device__ __forceinline__ void rows_fixed(const T* sa,
                                           const T (&bc)[D][vec_elems<T>()],
                                           T* ob, const KmArgs<T>& a, int lr,
                                           int col_l, int64_t row0,
                                           int64_t col0) {
  constexpr int VEC = vec_elems<T>();
  constexpr int PD = km_pd<T>(D);
  T r[KM_RB * VEC];
#pragma unroll
  for (int h = 0; h < KM_RB; ++h) {
    T ac[PD];
#pragma unroll
    for (int v = 0; v < PD; v += VEC) load16(sa + (lr + h) * PD + v, ac + v);
#pragma unroll
    for (int c = 0; c < VEC; ++c) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const T diff = ac[k] - bc[k][c];
        s += diff * diff;
      }
      r[h * VEC + c] = s;
    }
  }
  finish_rows<T, PHI>(r, a, ob, lr, col_l, row0, col0);
}

// D > 0: the tile from a landed stage. The row batches are unrolled in
// f32, where that measured faster at d = 8 on an H100, and not in f64,
// where it measured slower at d = 3
template <typename T, int PHI, int D>
__device__ __forceinline__ void tile_fixed(const T* st, T* ob,
                                           const KmArgs<T>& a, int64_t row0,
                                           int64_t col0) {
  constexpr int VEC = vec_elems<T>();
  constexpr int TN = km_tn<T>();
  const int col_l = (threadIdx.x & 31) * VEC;
  const int row_l = (threadIdx.x >> 5) * KM_RPW;
  const T* sa = st;
  const T* sb = st + KM_TM * km_pd<T>(D);
  T bc[D][VEC];
#pragma unroll
  for (int k = 0; k < D; ++k) load16(sb + k * TN + col_l, bc[k]);
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int p = 0; p < KM_RPW; p += KM_RB) {
      rows_fixed<T, PHI, D>(sa, bc, ob, a, row_l + p, col_l, row0, col0);
    }
  } else {
#pragma unroll 1
    for (int p = 0; p < KM_RPW; p += KM_RB) {
      rows_fixed<T, PHI, D>(sa, bc, ob, a, row_l + p, col_l, row0, col0);
    }
  }
}

// D = 0 (d > 8): slabs of KM_DK features through one shared stage, the sums
// in registers; the barriers keep a slab's reads apart from the next copy
template <typename T, int PHI>
__device__ __forceinline__ void tile_runtime(T* st, T* ob, const KmArgs<T>& a,
                                             int64_t row0, int64_t col0) {
  constexpr int VEC = vec_elems<T>();
  constexpr int TN = km_tn<T>();
  const int col_l = (threadIdx.x & 31) * VEC;
  const int row_l = (threadIdx.x >> 5) * KM_RPW;
  T* sa = st;                    // [KM_TM][KM_DK]
  T* sb = st + KM_TM * KM_DK;    // [KM_DK][TN]
  T acc[KM_RPW][VEC];
#pragma unroll
  for (int i = 0; i < KM_RPW; ++i) {
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[i][c] = T(0);
  }
  for (int64_t k0 = 0; k0 < a.d; k0 += KM_DK) {
    const int kc = static_cast<int>(a.d - k0 < KM_DK ? a.d - k0 : KM_DK);
    __syncthreads();
    for (int idx = threadIdx.x; idx < KM_TM * KM_DK; idx += KM_THREADS) {
      const int r = idx / KM_DK;
      const int k = idx - r * KM_DK;
      const int64_t g = row0 + r;
      sa[idx] = (g < a.na && k < kc) ? a.xa[g * a.d + k0 + k] : T(0);
    }
    for (int idx = threadIdx.x; idx < KM_DK * TN; idx += KM_THREADS) {
      const int k = idx / TN;
      const int c = idx - k * TN;
      const int64_t g = col0 + c;
      sb[idx] = (g < a.nb && k < kc) ? a.xb[g * a.d + k0 + k] : T(0);
    }
    __syncthreads();
    for (int k = 0; k < kc; ++k) {
      T b[VEC];
      load16(sb + k * TN + col_l, b);
#pragma unroll
      for (int i = 0; i < KM_RPW; ++i) {
        const T av = sa[(row_l + i) * KM_DK + k];
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          const T diff = av - b[c];
          acc[i][c] += diff * diff;
        }
      }
    }
  }
#pragma unroll
  for (int p = 0; p < KM_RPW; p += KM_RB) {
    T r[KM_RB * VEC];
#pragma unroll
    for (int h = 0; h < KM_RB; ++h) {
#pragma unroll
      for (int c = 0; c < VEC; ++c) r[h * VEC + c] = acc[p + h][c];
    }
    finish_rows<T, PHI>(r, a, ob, row_l + p, col_l, row0, col0);
  }
}

// ---------------------------------------------------------------------------
// the kernel: KM_THREADS threads, persistent over the tiles

template <typename T, int PHI, int D>
__global__ void __launch_bounds__(KM_THREADS, (D >= 1 && D <= 4) ? 3 : 2)
kernel_matrix_kernel(const __grid_constant__ CUtensorMap map,
                     const KmArgs<T> a) {
  constexpr int TN = km_tn<T>();
  constexpr int STAGE = km_stage_elems<T>(D);
  extern __shared__ unsigned char km_smem[];
  const unsigned s0 = static_cast<unsigned>(__cvta_generic_to_shared(km_smem));
  T* obuf = reinterpret_cast<T*>(
      km_smem + (KM_SMEM_ALIGN - s0 % KM_SMEM_ALIGN) % KM_SMEM_ALIGN);
  T* stages = obuf + (a.tma ? 2 * KM_TM * TN : 0);
  const bool leader = threadIdx.x == 0;
  const uint64_t policy = a.tma ? evict_first_policy() : 0;

  // tile t is row tile t / col_tiles, column tile t % col_tiles; the C
  // side keeps the tile count within 32 bits
  const unsigned col_tiles = static_cast<unsigned>(a.col_tiles);
  const unsigned tiles = static_cast<unsigned>(a.tiles);
  auto row_of = [&](unsigned t) {
    return static_cast<int64_t>(t / col_tiles) * KM_TM;
  };
  auto col_of = [&](unsigned t) {
    return static_cast<int64_t>(t % col_tiles) * TN;
  };
  unsigned tile = blockIdx.x;
  if constexpr (D > 0) {
    if (tile < tiles) stage_coords<T, D>(stages, a, row_of(tile), col_of(tile));
    cp_async_commit();
  }
  for (int it = 0; tile < tiles; tile += gridDim.x, ++it) {
    const int s = it & 1;
    const int64_t row0 = row_of(tile);
    const int64_t col0 = col_of(tile);
    if constexpr (D > 0) {
      // the next tile's coordinates fly while this one is computed; the
      // stage they overwrite was last read before the previous barrier B
      const unsigned next = tile + gridDim.x;
      if (next < tiles) {
        stage_coords<T, D>(stages + (s ^ 1) * STAGE, a, row_of(next),
                           col_of(next));
      }
      cp_async_commit();
      cp_async_wait<1>();
    }
    // the store started two tiles ago has read obuf[s]
    if (a.tma && leader) bulk_wait_read<1>();
    __syncthreads();   // A: this tile's coordinates landed, obuf[s] is free
    T* ob = obuf + s * KM_TM * TN;
    if constexpr (D > 0) {
      tile_fixed<T, PHI, D>(stages + s * STAGE, ob, a, row0, col0);
    } else {
      tile_runtime<T, PHI>(stages, ob, a, row0, col0);
    }
    if (a.tma) fence_proxy_async();
    __syncthreads();   // B: the tile is whole, its stage is read
    if (a.tma && leader) {
      tma_store_tile(&map, ob, static_cast<int>(col0), static_cast<int>(row0),
                     policy);
      bulk_commit();
    }
  }
  // the CTA's shared memory must outlive the reads of its last stores
  if (a.tma && leader) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// host side

template <typename T, int PHI, int D>
cudaError_t launch_kernel_matrix(const KmArgs<T>& a, cudaStream_t stream) {
  auto kern = kernel_matrix_kernel<T, PHI, D>;
  const size_t smem = km_smem_bytes<T>(D, a.tma != 0);
  static CtaCache cache;
  int64_t full = 0;
  cudaError_t err = persistent_ctas(kern, KM_THREADS, km_smem_bytes<T>(D, true),
                                    smem, a.tma, cache, &full);
  if (err != cudaSuccess) return err;
  const int64_t grid = a.tiles < full ? a.tiles : full;
  CUtensorMap map{};
  if (a.tma) {
    err = encode_store_map(&map, a.out, a.na, a.nb, a.ldo, KM_TM,
                           km_tn<T>());
    if (err != cudaSuccess) return err;
  }
  kern<<<static_cast<unsigned>(grid), KM_THREADS, smem, stream>>>(map, a);
  return cudaGetLastError();
}

template <typename T, int PHI>
cudaError_t kernel_matrix_dim(const KmArgs<T>& a, cudaStream_t s) {
  switch (a.d) {
    case 1: return launch_kernel_matrix<T, PHI, 1>(a, s);
    case 2: return launch_kernel_matrix<T, PHI, 2>(a, s);
    case 3: return launch_kernel_matrix<T, PHI, 3>(a, s);
    case 4: return launch_kernel_matrix<T, PHI, 4>(a, s);
    case 5: return launch_kernel_matrix<T, PHI, 5>(a, s);
    case 6: return launch_kernel_matrix<T, PHI, 6>(a, s);
    case 7: return launch_kernel_matrix<T, PHI, 7>(a, s);
    case 8: return launch_kernel_matrix<T, PHI, 8>(a, s);
    default: return launch_kernel_matrix<T, PHI, 0>(a, s);
  }
}

template <typename T>
int kernel_matrix(const void* xa, const void* xb, void* out, int64_t na,
                  int64_t nb, int64_t d, int64_t ldo, int64_t phi, double eps,
                  void* stream) {
  if (na <= 0 || nb <= 0 || d <= 0 || ldo < nb ||
      na - 1 > (INT64_MAX - nb) / ldo) {
    return cudaErrorInvalidValue;
  }
  const bool tma = tma_store_fits(out, na, nb, ldo, sizeof(T));
  const int64_t col_tiles = (nb + km_tn<T>() - 1) / km_tn<T>();
  const int64_t row_tiles = (na + KM_TM - 1) / KM_TM;
  if (row_tiles > (int64_t{INT_MAX} - 65536) / col_tiles) {
    return cudaErrorInvalidValue;   // over 2^31 tiles: some 2^44 elements
  }
  const KmArgs<T> a{static_cast<const T*>(xa), static_cast<const T*>(xb),
                    static_cast<T*>(out), na, nb, d, ldo, col_tiles,
                    row_tiles * col_tiles, static_cast<T>(eps),
                    static_cast<int>(tma)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phi) {
    case PHI_LINEAR: return kernel_matrix_dim<T, PHI_LINEAR>(a, s);
    case PHI_MULTIQUADRIC: return kernel_matrix_dim<T, PHI_MULTIQUADRIC>(a, s);
    case PHI_CUBIC: return kernel_matrix_dim<T, PHI_CUBIC>(a, s);
    case PHI_GAUSSIAN: return kernel_matrix_dim<T, PHI_GAUSSIAN>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* corrla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int corrla_kernel_matrix_f32(const void* xa, const void* xb, void* out,
                             int64_t na, int64_t nb, int64_t d, int64_t ldo,
                             int64_t phi, double eps, void* stream) {
  return kernel_matrix<float>(xa, xb, out, na, nb, d, ldo, phi, eps, stream);
}

int corrla_kernel_matrix_f64(const void* xa, const void* xb, void* out,
                             int64_t na, int64_t nb, int64_t d, int64_t ldo,
                             int64_t phi, double eps, void* stream) {
  return kernel_matrix<double>(xa, xb, out, na, nb, d, ldo, phi, eps, stream);
}

// 1 where corrla_kernel_matrix_{f32,f64} would store into this output by
// TMA, 0 where it stores directly
int corrla_kernel_matrix_tma(const void* out, int64_t na, int64_t nb,
                             int64_t ldo, int64_t itemsize) {
  return tma_store_fits(out, na, nb, ldo, itemsize) ? 1 : 0;
}

}  // extern "C"
