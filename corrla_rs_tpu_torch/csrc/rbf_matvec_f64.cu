// C entry point of the streaming RBF matvec (rbf_matvec.cuh) for double.
// Its own translation unit, so that it compiles beside the others.

#include <cstdint>

#include "rbf_matvec.cuh"

extern "C" int corrla_rbf_matvec_f64(const void* q, const void* x,
                                      const void* c, void* out, void* scratch,
                                      int64_t m, int64_t n, int64_t d,
                                      int64_t ncols, int64_t phi, double eps,
                                      int64_t cols, int64_t splits,
                                      int64_t split_len, void* stream) {
  return corrla::rbf_matvec<double>(q, x, c, out, scratch, m, n, d, ncols, phi,
                                  eps, cols, splits, split_len, stream);
}
