// Shared by the port's store-bound kernels (the kernel matrix in
// rbf_kernels.cu, the modes product in modes_product.cu): how a finished
// output tile leaves the CTA, and how many persistent CTAs fill the card.
//
// - TMA: the tile sits in shared memory and one thread stores it with
//   cp.async.bulk.tensor and an evict-first L2 hint; the hardware clips the
//   ragged edge. The tensor map comes from cuTensorMapEncodeTiled, reached
//   through the runtime's entry-point query, so the library needs no -lcuda.
//   TMA needs a 16-byte-aligned base and row stride and int32 coordinates
//   (tma_store_fits).
// - Direct: each thread stores its 16 bytes straight from registers with
//   st.global.cs, in narrower pieces where the address is not aligned or
//   the row ends.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>

namespace corrla {

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map,
                                               const void* smem, int col,
                                               int row, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%1, %2}], [%3], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(col), "r"(row),
      "r"(static_cast<unsigned>(__cvta_generic_to_shared(smem))),
      "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most PENDING bulk groups still reading their shared source
template <int PENDING>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(PENDING)
               : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// this thread's shared-memory writes, made visible to the TMA (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the first `valid` of v's VEC values to p, with evict-first stores
__device__ __forceinline__ void store_direct(float* p, const float* v,
                                             int valid) {
  const auto a = reinterpret_cast<uintptr_t>(p);
  if (valid >= 4 && (a & 15) == 0) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if (valid >= 4 && (a & 7) == 0) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
    __stcs(reinterpret_cast<float2*>(p + 2), make_float2(v[2], v[3]));
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c < valid) __stcs(p + c, v[c]);
    }
  }
}

__device__ __forceinline__ void store_direct(double* p, const double* v,
                                             int valid) {
  const auto a = reinterpret_cast<uintptr_t>(p);
  if (valid >= 2 && (a & 15) == 0) {
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
  } else {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c < valid) __stcs(p + c, v[c]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime; null if the
// installed CUDA has none
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// whether the (rows, cols) output at out, rows ldo elements of itemsize
// bytes apart, can be stored by TMA: a 16-byte-aligned base and row stride
// (below 2^40 bytes), int32 coordinates
inline bool tma_store_fits(const void* out, int64_t rows, int64_t cols,
                           int64_t ldo, int64_t itemsize) {
  const auto base = reinterpret_cast<uintptr_t>(out);
  const int64_t stride_bytes = ldo * itemsize;
  return base % 16 == 0 && stride_bytes % 16 == 0 &&
         stride_bytes < (int64_t{1} << 40) && rows <= INT_MAX &&
         cols <= INT_MAX;
}

// the (rows, cols) output at out (cols innermost, rows ldo elements apart)
// as a 2-D tensor map whose box is one box_rows x box_cols tile
template <typename T>
cudaError_t encode_store_map(CUtensorMap* map, T* out, int64_t rows,
                             int64_t cols, int64_t ldo, int box_rows,
                             int box_cols) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ldo) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(
      map,
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                     : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
      2, out, dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the persistent grid of one kernel instance, by device and store path,
// found on its first launch there; each instance keeps one in a static
struct CtaCache {
  static constexpr int kDevices = 16;   // devices whose grid is kept
  std::atomic<int64_t> full[kDevices][2];
};

// the CTAs an SM holds of kern (threads a CTA, smem bytes of dynamic shared
// memory on this launch's store path, smem_max on the larger one) times the
// SMs: the grid of persistent CTAs that fills the card, into *full
template <typename Kern>
cudaError_t persistent_ctas(Kern kern, int threads, size_t smem_max,
                            size_t smem, int tma, CtaCache& cache,
                            int64_t* full) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool kept = dev < CtaCache::kDevices;
  *full = kept ? cache.full[dev][tma].load(std::memory_order_relaxed) : 0;
  if (*full != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_max));
  if (err != cudaSuccess) return err;
  int ctas = 0;
  int sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (ctas < 1) return cudaErrorInvalidConfiguration;
  *full = static_cast<int64_t>(ctas) * sms;
  if (kept) cache.full[dev][tma].store(*full, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace corrla
