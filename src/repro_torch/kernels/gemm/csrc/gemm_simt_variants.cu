// GEMM, route "simt": the tuner's launch variants other than the default
// (gemm_simt.cu), each an instantiation of gemm_simt.cuh's kernel: a
// 128 x 64 tile of 4 warps and a 64 x 64 tile of 2.
//
// C interface (loaded with ctypes):
//   int gemm_simt_variant_launch(const void *a, const void *b, void *c,
//                                int M, int N, int K, int dtype, int vec_a,
//                                int vec_b, int vec_c, int whole,
//                                int tile_m, int tile_n, int grid,
//                                cudaStream_t stream);
//   as gemm_simt_launch, for the variant tile_m x tile_n; any other tile
//   returns cudaErrorInvalidValue.
//   const char *gemm_simt_error_string(int code);

#include "gemm_simt.cuh"

extern "C" int gemm_simt_variant_launch(const void *a, const void *b,
                                        void *c, int M, int N, int K,
                                        int dtype, int vec_a, int vec_b,
                                        int vec_c, int whole, int tile_m,
                                        int tile_n, int grid,
                                        cudaStream_t stream) {
  if (tile_m == 128 && tile_n == 64)
    return launch_variant<128, 64>(a, b, c, M, N, K, dtype, vec_a, vec_b,
                                   vec_c, whole, grid, stream);
  if (tile_m == 64 && tile_n == 64)
    return launch_variant<64, 64>(a, b, c, M, N, K, dtype, vec_a, vec_b,
                                  vec_c, whole, grid, stream);
  return (int)cudaErrorInvalidValue;
}
