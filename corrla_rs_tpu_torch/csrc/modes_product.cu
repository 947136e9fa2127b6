// Hand-written Hopper (sm_90a) kernel for PodI's modes product:
//
//   corrla_modes_product_{f32,f64}
//     out[i * ldo + j] = sum_{m < k} modes[i, m] w[j, m],
//                        i < n_pts, j < n_q, ldo >= n_q, 1 <= k <= 32,
//
// the field y(t) = modes w(t)^T of n_q queries over n_pts points. modes and
// w are read through their strides, so the modes PodI.fit leaves (vt.mT, a
// strided view of the RSVD's V, in either layout), a loaded checkpoint's and
// an exported program's dense constant all go in without a copy. The
// output is an (n_pts, n_q) view whose rows lie ldo elements apart.
//
// It replaces no TPU kernel: the JAX package leaves modes @ w.T to XLA. It
// exists because cuBLAS runs this shape (k = 20, TF32 off) as a SIMT GEMM
// tiled for compute, at about half the rate the card can write the field.
//
// What bounds it on an H100: the stores. The output is n_pts n_q elements
// of 4 or 8 bytes, written once; the modes and weights (16 MB and 1.3 MB at
// 200,000 x 16,384 x 20 f32) are read once from HBM and then from L2. Each
// element takes k FMAs: 2k operations against 4 or 8 bytes, under the
// card's ridge (67 TFLOP/s over 3.35 TB/s, 20 operations a byte in f32; 34
// over 3.35, 10 in f64) for every k <= 32. At k = 20 f32 the stores take
// 3.92 ms and the FMAs 1.96 ms, so the FMA issue has to overlap the stores;
// the kernel takes about 4.8 ms there, 81% of the bound (cuBLAS's SIMT GEMM
// 7.8-9.0 ms). The design:
//
//   1. Persistent CTAs, one an SM (8 warps). Each walks output tiles of
//      mp_tm x mp_tn rows x columns (160 x 128 f32, 128 x 64 f64: a warp's
//      row is 512 bytes). A unit of work is a column tile of `sr` row tiles
//      (sr = 8 at the cell's shape, fewer where the grid would be left with
//      too few units a CTA); units go to the CTAs in row-major order, u =
//      blockIdx.x, += gridDim.x, so the CTAs in flight write the same few
//      bands of whole rows.
//   2. Weights in registers, modes from shared memory. Each thread owns
//      VEC consecutive columns (4 f32, 2 f64) and keeps their k weights in
//      registers for the whole unit. A unit's weights come once, by
//      coalesced cp.async into a transposed shared tile, and from there by
//      16-byte loads (each lane reading its own 16 bytes from L2 had the
//      lanes 80 k bytes apart, a cache line a lane). A row's k modes come
//      from 16-byte broadcast shared loads (one address a warp), MP_RB
//      rows at a time; while a tile is computed, cp.async stages the next
//      tile's rows in the other of two buffers, zeros past n_pts.
//   3. Arithmetic. k FMAs an element in mode order, the first product the
//      start: plain f32 (or f64), no tensor cores, no TF32, no split
//      products. An element's bits depend only on its row of modes and its
//      row of weights, never on the tile, the grid or the store path.
//   4. Stores (tile_store.cuh), chosen here from the output's address and
//      row stride as the kernel matrix's: where TMA takes the output, each
//      finished tile goes to one of two shared buffers and one thread
//      stores it by TMA (evict-first), overlapping the next tile's math;
//      else each thread stores its VEC values with st.global.cs (slower:
//      5.8 ms at the cell's shape). Element offsets are 64-bit (3.28e9
//      elements at the cell's shape).
//
// The grid is the kernel matrix's (persistent_ctas in tile_store.cuh). Its
// tiles cost about 0.05 ms whatever the width, so below about 80 queries
// cuBLAS is faster, and ops/rbf_kernels.py sends such calls to
// torch.matmul (_MODES_MIN_Q).
//
// Plain C interface for ctypes, as rbf_kernels.cu: raw device pointers,
// int64 sizes and strides in elements, a cudaStream_t; launches on that
// stream without synchronising and returns cudaGetLastError(). What it
// cannot take (k outside 1..32, ldo < n_q, an empty output, more than 2^31
// units) returns cudaErrorInvalidValue without a launch.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <utility>

#include "rbf_common.cuh"
#include "tile_store.cuh"

namespace {

using namespace corrla;

constexpr int MP_WARPS = 8;
constexpr int MP_THREADS = MP_WARPS * 32;
constexpr int MP_RB = 4;                   // rows a thread sums at once
constexpr int MP_NBUF = 2;                 // output tiles in shared memory
constexpr int MP_MAX_K = 32;
constexpr int MP_MAX_SR = 8;               // row tiles a unit at most
constexpr int MP_UNITS_PER_CTA = 16;       // fewest units a CTA, where sr > 1
constexpr int MP_SMEM_ALIGN = 128;         // a TMA source's alignment

// tile columns: a warp's 32 threads x 16 bytes
template <typename T>
__host__ __device__ constexpr int mp_tn() {
  return 32 * vec_elems<T>();
}

// tile rows: 160 in f32, where two 80 KB output tiles and, at k = 32, 57 KB
// of modes and weights fit the 227 KB a CTA may hold; 128 in f64. Taller
// tiles measured faster on an H100 (64, 128, 160 rows: 6.2, 5.2, 4.8 ms
// at 200,000 x 16,384 x 20 f32), as a tile's fixed costs spread
template <typename T>
__host__ __device__ constexpr int mp_tm() {
  return sizeof(T) == 4 ? 160 : 128;
}

// rows a warp
template <typename T>
__host__ __device__ constexpr int mp_rpw() {
  return mp_tm<T>() / MP_WARPS;
}

// a staged row of modes: k rounded up to whole 16-byte loads
template <typename T, int K>
__host__ __device__ constexpr int mp_kp() {
  return static_cast<int>(round_up(K, vec_elems<T>()));
}

// row stride of the staged weights [K][mp_ldw]: a tile's columns and 16
// bytes of padding, so that the transposing writes spread over the banks
template <typename T>
__host__ __device__ constexpr int mp_ldw() {
  return mp_tn<T>() + vec_elems<T>();
}

// dynamic shared memory of a CTA: alignment slack, the output tiles (TMA
// path only), the two stages of modes rows, the unit's weights
template <typename T, int K>
size_t mp_smem_bytes(bool tma) {
  const size_t out = tma ? MP_NBUF * mp_tm<T>() * mp_tn<T>() : 0;
  return MP_SMEM_ALIGN + sizeof(T) * (out + 2 * mp_tm<T>() * mp_kp<T, K>() +
                                      K * mp_ldw<T>());
}

template <typename T>
struct MpArgs {
  const T* modes;
  const T* w;
  T* out;
  int64_t n_pts, n_q, ldo;
  int64_t sm_row, sm_col, sw_row, sw_col;   // strides, in elements
  int64_t row_tiles, col_tiles, units, sr;
  int tma;
};

__device__ __forceinline__ float mul_t(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_t(double a, double b) {
  return __dmul_rn(a, b);
}

// a position in a CTA's walk: unit u and its j-th row tile
struct Pos {
  unsigned u;
  int j;
};

// the next tile of this CTA: the unit's next row tile, else the first of
// its next unit
template <typename T>
__device__ __forceinline__ Pos next_pos(Pos p, const MpArgs<T>& a) {
  const unsigned band = p.u / static_cast<unsigned>(a.col_tiles);
  const int64_t rt = static_cast<int64_t>(band) * a.sr + p.j + 1;
  if (p.j + 1 < a.sr && rt < a.row_tiles) return {p.u, p.j + 1};
  return {p.u + gridDim.x, 0};
}

template <typename T>
__device__ __forceinline__ int64_t row_of(Pos p, const MpArgs<T>& a) {
  const unsigned band = p.u / static_cast<unsigned>(a.col_tiles);
  return (static_cast<int64_t>(band) * a.sr + p.j) * mp_tm<T>();
}

template <typename T>
__device__ __forceinline__ int64_t col_of(Pos p, const MpArgs<T>& a) {
  return static_cast<int64_t>(p.u % static_cast<unsigned>(a.col_tiles)) *
         mp_tn<T>();
}

// rows row0 .. row0 + mp_tm - 1 of the modes into a stage [mp_tm][KP] by
// cp.async, zeros past n_pts and in a row's padding; the thread order
// follows the modes' unit stride, so the global reads coalesce
template <typename T, int K>
__device__ __forceinline__ void stage_modes(T* st, const MpArgs<T>& a,
                                            int64_t row0) {
  constexpr int KP = mp_kp<T, K>();
  if (a.sm_row == 1) {
    for (int idx = threadIdx.x; idx < KP * mp_tm<T>(); idx += MP_THREADS) {
      const int m = idx / mp_tm<T>();
      const int r = idx - m * mp_tm<T>();
      const int64_t g = row0 + r;
      const bool ok = m < K && g < a.n_pts;
      cp_async_zfill<sizeof(T)>(
          st + r * KP + m, ok ? a.modes + g + m * a.sm_col : a.modes, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < mp_tm<T>() * KP; idx += MP_THREADS) {
      const int r = idx / KP;
      const int m = idx - r * KP;
      const int64_t g = row0 + r;
      const bool ok = m < K && g < a.n_pts;
      cp_async_zfill<sizeof(T)>(
          st + idx, ok ? a.modes + g * a.sm_row + m * a.sm_col : a.modes, ok);
    }
  }
}

// the weights of the columns col0 .. col0 + mp_tn - 1 into sw [K][mp_ldw],
// transposed, by cp.async, zeros past n_q; the thread order follows a
// row of w, so the global reads of row-major weights coalesce
template <typename T, int K>
__device__ __forceinline__ void stage_weights(T* sw, const MpArgs<T>& a,
                                              int64_t col0) {
  constexpr int N = mp_tn<T>() * K;
#pragma unroll
  for (int t = 0; t < (N + MP_THREADS - 1) / MP_THREADS; ++t) {
    const int idx = threadIdx.x + t * MP_THREADS;
    if (idx < N) {
      const int c = idx / K;
      const int m = idx - c * K;
      const int64_t j = col0 + c;
      const bool ok = j < a.n_q;
      cp_async_zfill<sizeof(T)>(
          sw + m * mp_ldw<T>() + c,
          ok ? a.w + j * a.sw_row + m * a.sw_col : a.w, ok);
    }
  }
}

// the tile from a landed stage: this thread's mp_rpw rows x VEC columns,
// MP_RB rows at a time, each row's modes VEC at a time by a broadcast
// 16-byte load; into the shared tile (TMA) or straight to the output
template <typename T, int K>
__device__ __forceinline__ void tile(const T* sa,
                                     const T (&wr)[K][vec_elems<T>()], T* ob,
                                     const MpArgs<T>& a, int64_t row0,
                                     int64_t col0) {
  constexpr int VEC = vec_elems<T>();
  constexpr int KP = mp_kp<T, K>();
  constexpr int TN = mp_tn<T>();
  const int col_l = (threadIdx.x & 31) * VEC;
  const int row_l = (threadIdx.x >> 5) * mp_rpw<T>();
#pragma unroll 1
  for (int i = 0; i < mp_rpw<T>(); i += MP_RB) {
    T acc[MP_RB][VEC];
#pragma unroll
    for (int v = 0; v < KP; v += VEC) {
      T am[MP_RB][VEC];
#pragma unroll
      for (int h = 0; h < MP_RB; ++h) {
        load16(sa + (row_l + i + h) * KP + v, am[h]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int m = v + e;
        if (m < K) {
#pragma unroll
          for (int h = 0; h < MP_RB; ++h) {
#pragma unroll
            for (int c = 0; c < VEC; ++c) {
              acc[h][c] = m == 0 ? mul_t(am[h][e], wr[m][c])
                                 : fma_t(am[h][e], wr[m][c], acc[h][c]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < MP_RB; ++h) {
      const int lr = row_l + i + h;
      if (a.tma) {
        store16(ob + lr * TN + col_l, acc[h]);
      } else {
        const int64_t row = row0 + lr;
        const int64_t col = col0 + col_l;
        if (row < a.n_pts && col < a.n_q) {
          const int64_t left = a.n_q - col;
          store_direct(a.out + row * a.ldo + col, acc[h],
                       left < VEC ? static_cast<int>(left) : VEC);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the kernel: MP_THREADS threads, persistent over the units

// one CTA an SM: a thread's weights are 16 bytes a mode, 4k registers, and
// its MP_RB rows' sums and modes take 8 MP_RB more
template <typename T, int K>
__global__ void __launch_bounds__(MP_THREADS, 1)
modes_product_kernel(const __grid_constant__ CUtensorMap map,
                     const MpArgs<T> a) {
  constexpr int VEC = vec_elems<T>();
  constexpr int TN = mp_tn<T>();
  constexpr int STAGE = mp_tm<T>() * mp_kp<T, K>();
  extern __shared__ unsigned char mp_smem[];
  const unsigned s0 =
      static_cast<unsigned>(__cvta_generic_to_shared(mp_smem));
  T* obuf = reinterpret_cast<T*>(
      mp_smem + (MP_SMEM_ALIGN - s0 % MP_SMEM_ALIGN) % MP_SMEM_ALIGN);
  T* stages = obuf + (a.tma ? MP_NBUF * mp_tm<T>() * TN : 0);
  T* sw = stages + 2 * STAGE;
  const bool leader = threadIdx.x == 0;
  const uint64_t policy = a.tma ? evict_first_policy() : 0;
  const unsigned units = static_cast<unsigned>(a.units);

  T wr[K][VEC];
  unsigned w_unit = UINT_MAX;
  Pos cur{blockIdx.x, 0};
  if (cur.u < units) stage_modes<T, K>(stages, a, row_of(cur, a));
  cp_async_commit();
  for (int it = 0; cur.u < units; ++it) {
    const int s = it & 1;
    const int64_t row0 = row_of(cur, a);
    const int64_t col0 = col_of(cur, a);
    // a unit's first tile: its weights, in a group of their own; sw was
    // last read after a barrier A that at least one barrier B followed
    const bool new_unit = cur.u != w_unit;
    if (new_unit) {
      stage_weights<T, K>(sw, a, col0);
      cp_async_commit();
    }
    // the next tile's modes fly while this one is computed; the stage they
    // overwrite was last read before the previous barrier B
    const Pos nxt = next_pos(cur, a);
    if (nxt.u < units) {
      stage_modes<T, K>(stages + (s ^ 1) * STAGE, a, row_of(nxt, a));
    }
    cp_async_commit();
    cp_async_wait<1>();
    // the store started MP_NBUF tiles ago has read this tile's buffer
    if (a.tma && leader) bulk_wait_read<MP_NBUF - 1>();
    __syncthreads();   // A: this tile's modes (and weights) landed, its
                       // output buffer is free
    if (new_unit) {
#pragma unroll
      for (int m = 0; m < K; ++m) {
        load16(sw + m * mp_ldw<T>() + (threadIdx.x & 31) * VEC, wr[m]);
      }
      w_unit = cur.u;
    }
    T* ob = obuf + it % MP_NBUF * mp_tm<T>() * TN;
    tile<T, K>(stages + s * STAGE, wr, ob, a, row0, col0);
    if (a.tma) fence_proxy_async();
    __syncthreads();   // B: the tile is whole, its stage is read
    if (a.tma && leader) {
      tma_store_tile(&map, ob, static_cast<int>(col0), static_cast<int>(row0),
                     policy);
      bulk_commit();
    }
    cur = nxt;
  }
  // the CTA's shared memory must outlive the reads of its last stores
  if (a.tma && leader) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// host side

template <typename T, int K>
cudaError_t launch_modes_product(MpArgs<T> a, cudaStream_t stream) {
  auto kern = modes_product_kernel<T, K>;
  const size_t smem = mp_smem_bytes<T, K>(a.tma != 0);
  static CtaCache cache;
  int64_t full = 0;
  cudaError_t err = persistent_ctas(kern, MP_THREADS,
                                    mp_smem_bytes<T, K>(true), smem, a.tma,
                                    cache, &full);
  if (err != cudaSuccess) return err;
  // as many row tiles a unit as leave every CTA MP_UNITS_PER_CTA units
  const int64_t tiles = a.row_tiles * a.col_tiles;
  int64_t sr = tiles / (full * MP_UNITS_PER_CTA);
  sr = sr < 1 ? 1 : (sr > MP_MAX_SR ? MP_MAX_SR : sr);
  a.sr = sr;
  a.units = (a.row_tiles + sr - 1) / sr * a.col_tiles;
  if (a.units > int64_t{INT_MAX} - full) return cudaErrorInvalidValue;
  const int64_t grid = a.units < full ? a.units : full;
  CUtensorMap map{};
  if (a.tma) {
    err = encode_store_map(&map, a.out, a.n_pts, a.n_q, a.ldo, mp_tm<T>(),
                           mp_tn<T>());
    if (err != cudaSuccess) return err;
  }
  kern<<<static_cast<unsigned>(grid), MP_THREADS, smem, stream>>>(map, a);
  return cudaGetLastError();
}

// the instance of k, one of 1..MP_MAX_K
template <typename T, int... Ks>
cudaError_t launch_for_k(int64_t k, const MpArgs<T>& a, cudaStream_t s,
                         std::integer_sequence<int, Ks...>) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((k == Ks + 1 ? (err = launch_modes_product<T, Ks + 1>(a, s), true)
                      : false) ||
         ...);
  return err;
}

template <typename T>
int modes_product(const void* modes, const void* w, void* out, int64_t n_pts,
                  int64_t n_q, int64_t k, int64_t sm_row, int64_t sm_col,
                  int64_t sw_row, int64_t sw_col, int64_t ldo, void* stream) {
  if (n_pts <= 0 || n_q <= 0 || k < 1 || k > MP_MAX_K || ldo < n_q ||
      n_pts - 1 > (INT64_MAX - n_q) / ldo) {
    return cudaErrorInvalidValue;
  }
  const int64_t col_tiles = (n_q + mp_tn<T>() - 1) / mp_tn<T>();
  const int64_t row_tiles = (n_pts + mp_tm<T>() - 1) / mp_tm<T>();
  if (row_tiles > int64_t{INT_MAX} / col_tiles) {
    return cudaErrorInvalidValue;   // over 2^31 tiles: some 2^44 elements
  }
  const MpArgs<T> a{static_cast<const T*>(modes),
                    static_cast<const T*>(w),
                    static_cast<T*>(out),
                    n_pts, n_q, ldo, sm_row, sm_col, sw_row, sw_col,
                    row_tiles, col_tiles, 0, 1,
                    tma_store_fits(out, n_pts, n_q, ldo, sizeof(T)) ? 1 : 0};
  return launch_for_k<T>(k, a, static_cast<cudaStream_t>(stream),
                         std::make_integer_sequence<int, MP_MAX_K>{});
}

}  // namespace

extern "C" {

int corrla_modes_product_f32(const void* modes, const void* w, void* out,
                             int64_t n_pts, int64_t n_q, int64_t k,
                             int64_t sm_row, int64_t sm_col, int64_t sw_row,
                             int64_t sw_col, int64_t ldo, void* stream) {
  return modes_product<float>(modes, w, out, n_pts, n_q, k, sm_row, sm_col,
                              sw_row, sw_col, ldo, stream);
}

int corrla_modes_product_f64(const void* modes, const void* w, void* out,
                             int64_t n_pts, int64_t n_q, int64_t k,
                             int64_t sm_row, int64_t sm_col, int64_t sw_row,
                             int64_t sw_col, int64_t ldo, void* stream) {
  return modes_product<double>(modes, w, out, n_pts, n_q, k, sm_row, sm_col,
                               sw_row, sw_col, ldo, stream);
}

}  // extern "C"
