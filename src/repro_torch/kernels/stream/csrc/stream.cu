// STREAM copy / scale / add / triad: the default launch variant, 256
// threads a block of 4 16-byte vectors each.  The kernels, their design
// and their numerics are in stream.cuh; stream_variants.cu holds the
// tuner's other variants.
//
// C interface (loaded with ctypes):
//   int stream_launch(const void *a, const void *b, void *c, long long n,
//                     int op, float q, int dtype, cudaStream_t stream);
//   op: 0 copy, 1 scale, 2 add, 3 triad; dtype: 0 fp32, 1 bf16, 2 fp16;
//   b is read by add and triad only.  Returns a cudaError_t code.
//   const char *stream_error_string(int code);

#include "stream.cuh"

extern "C" int stream_launch(const void *a, const void *b, void *c,
                             long long n, int op, float q, int dtype,
                             cudaStream_t stream) {
  return launch_variant<256, 4>(a, b, c, n, op, q, dtype, stream);
}
