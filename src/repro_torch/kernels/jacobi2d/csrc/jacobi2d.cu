// One 5-point Jacobi sweep: the default launch variant, 32 x 8 blocks.  The
// kernel, its design and its numerics are in jacobi2d.cuh;
// jacobi2d_variants.cu holds the tuner's other variants.
//
// C interface (loaded with ctypes):
//   int jacobi2d_launch(const void *u, void *out, int H, int W, int dtype,
//                       cudaStream_t stream);      dtype: 0 fp32, 1 bf16
//   const char *jacobi2d_error_string(int code);

#include "jacobi2d.cuh"

extern "C" int jacobi2d_launch(const void *u, void *out, int H, int W,
                               int dtype, cudaStream_t stream) {
  return launch_variant<8>(u, out, H, W, dtype, stream);
}
