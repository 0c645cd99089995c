// GEMM, route "wgmma": the default launch variant, a 128 x 256 x 64 tile
// in a ring of 4 stages.  The kernel, its design and its numerics are in
// gemm_wgmma.cuh; gemm_wgmma_variants.cu holds the tuner's other variants.
//
// C interface (loaded with ctypes):
//   int gemm_wgmma_launch(const void *a, const void *b, void *c, int M,
//                         int N, int K, int grid, int smem, int device,
//                         cudaStream_t stream);
//   row-major bf16 A (M, K), B (K, N), C (M, N); grid and smem from
//   kernel.gemm_plan, which must equal this variant's.  Returns a
//   cudaError_t, or one of gemm_wgmma.cuh's codes from kNoEncoder up.
//   const char *gemm_wgmma_error_string(int code);

#include "gemm_wgmma.cuh"

namespace {
constexpr int kBN = 256;  // the default variant's tile width and stages
constexpr int kStages = 4;
}  // namespace

extern "C" int gemm_wgmma_launch(const void *a, const void *b, void *c, int M,
                                 int N, int K, int grid, int smem, int device,
                                 cudaStream_t stream) {
  return launch<kBN, kStages>(a, b, c, M, N, K, grid, smem, device, stream);
}
