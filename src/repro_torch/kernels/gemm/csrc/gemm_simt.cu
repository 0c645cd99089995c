// GEMM, route "simt": the default launch variant, a 128 x 128 tile of 8
// warps.  The kernel, its design and its numerics are in gemm_simt.cuh;
// gemm_simt_variants.cu holds the tuner's other variants.
//
// C interface (loaded with ctypes):
//   int gemm_simt_launch(const void *a, const void *b, void *c, int M, int N,
//                        int K, int dtype, int vec_a, int vec_b, int vec_c,
//                        int whole, int grid, cudaStream_t stream);
//   row-major A (M, K), B (K, N), C (M, N); dtype: 0 fp32, 1 bf16; the
//   vector flags, whole (every tile inside M, N and K, both operands read
//   as vectors) and the grid from kernel.gemm_plan.
//   const char *gemm_simt_error_string(int code);

#include "gemm_simt.cuh"

namespace {
constexpr int kBM = 128, kBN = 128;  // the default variant's tile
}  // namespace

extern "C" int gemm_simt_launch(const void *a, const void *b, void *c, int M,
                                int N, int K, int dtype, int vec_a, int vec_b,
                                int vec_c, int whole, int grid,
                                cudaStream_t stream) {
  return launch_variant<kBM, kBN>(a, b, c, M, N, K, dtype, vec_a, vec_b,
                                  vec_c, whole, grid, stream);
}
