// One 5-point Jacobi sweep: the tuner's launch variants other than the
// default (jacobi2d.cu), each an instantiation of jacobi2d.cuh's kernel:
// blocks of 32 x 4, 32 x 16 and 32 x 32 threads.
//
// C interface (loaded with ctypes):
//   int jacobi2d_variant_launch(const void *u, void *out, int H, int W,
//                               int dtype, int tile_h, cudaStream_t stream);
//   as jacobi2d_launch, for the variant of tile_h rows; any other tile_h
//   returns cudaErrorInvalidValue.
//   const char *jacobi2d_error_string(int code);

#include "jacobi2d.cuh"

extern "C" int jacobi2d_variant_launch(const void *u, void *out, int H,
                                       int W, int dtype, int tile_h,
                                       cudaStream_t stream) {
  switch (tile_h) {
    case 4: return launch_variant<4>(u, out, H, W, dtype, stream);
    case 16: return launch_variant<16>(u, out, H, W, dtype, stream);
    case 32: return launch_variant<32>(u, out, H, W, dtype, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
