// GEMM, route "wgmma": the tuner's launch variants other than the default
// (gemm_wgmma.cu), each an instantiation of gemm_wgmma.cuh's kernel:
// 128 x 256 x 64 in 3 stages, and 128 x 128 x 64 in 4.
//
// C interface (loaded with ctypes):
//   int gemm_wgmma_variant_launch(const void *a, const void *b, void *c,
//                                 int M, int N, int K, int tile_n,
//                                 int stages, int grid, int smem,
//                                 int device, cudaStream_t stream);
//   as gemm_wgmma_launch, for the variant (tile_n, stages); any other
//   pair returns cudaErrorInvalidValue.
//   const char *gemm_wgmma_error_string(int code);

#include "gemm_wgmma.cuh"

extern "C" int gemm_wgmma_variant_launch(const void *a, const void *b,
                                         void *c, int M, int N, int K,
                                         int tile_n, int stages, int grid,
                                         int smem, int device,
                                         cudaStream_t stream) {
  if (tile_n == 256 && stages == 3)
    return launch<256, 3>(a, b, c, M, N, K, grid, smem, device, stream);
  if (tile_n == 128 && stages == 4)
    return launch<128, 4>(a, b, c, M, N, K, grid, smem, device, stream);
  return (int)cudaErrorInvalidValue;
}
