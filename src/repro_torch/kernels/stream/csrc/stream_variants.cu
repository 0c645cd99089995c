// STREAM copy / scale / add / triad: the tuner's launch variants other than
// the default (stream.cu), each an instantiation of stream.cuh's kernels:
// {128, 256, 512} threads a block x {2, 4, 8} 16-byte vectors a thread,
// but 256 x 4.
//
// C interface (loaded with ctypes):
//   int stream_variant_launch(const void *a, const void *b, void *c,
//                             long long n, int op, float q, int dtype,
//                             int threads, int vecs, cudaStream_t stream);
//   as stream_launch, for the variant (threads, vecs); any other pair
//   returns cudaErrorInvalidValue.
//   const char *stream_error_string(int code);

#include "stream.cuh"

extern "C" int stream_variant_launch(const void *a, const void *b, void *c,
                                     long long n, int op, float q, int dtype,
                                     int threads, int vecs,
                                     cudaStream_t stream) {
#define STREAM_VARIANT(T, U)                                         \
  if (threads == T && vecs == U)                                     \
    return launch_variant<T, U>(a, b, c, n, op, q, dtype, stream);
  STREAM_VARIANT(256, 2)
  STREAM_VARIANT(256, 8)
  STREAM_VARIANT(128, 2)
  STREAM_VARIANT(128, 4)
  STREAM_VARIANT(128, 8)
  STREAM_VARIANT(512, 2)
  STREAM_VARIANT(512, 4)
  STREAM_VARIANT(512, 8)
#undef STREAM_VARIANT
  return (int)cudaErrorInvalidValue;
}
