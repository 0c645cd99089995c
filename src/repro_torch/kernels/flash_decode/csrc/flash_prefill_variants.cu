// Chunked prefill over a paged KV cache: the tuner's launch variants of the
// attention other than the default (flash_prefill_paged.cu), each an
// instantiation of flash_prefill_paged.cuh's kernels, for f32 q over f32
// pools (the fp32 route) and bf16 q over bf16 pools (the mma route), the
// pairs the tuning space reaches: 64 query vectors a block with key tiles
// of 32 rows, and 32 query vectors with key tiles of 64 and of 32.  The
// commit runs first, as in the default launch.
//
// C interface (loaded with ctypes):
//   int flash_prefill_variant_launch(<flash_prefill_paged_launch's
//       arguments up to pool_dtype>, int vectors, int keys, int device,
//       void *stream);
//   rows * G <= vectors and kt <= keys, from kernel.prefill_plan; any other
//   (vectors, keys) or (q, pool) pair returns cudaErrorInvalidValue.
//   const char *flash_prefill_error_string(int code);

#include "flash_prefill_paged.cuh"

extern "C" int flash_prefill_variant_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* k_amax,
    const void* v_amax, const void* block_tables, const void* q_start,
    const void* q_len, void* out, int B, int C, int KV, int G, int D, int bs,
    int nb, int rows, int kt, int smem, int dtype, int pool_dtype,
    int vectors, int keys, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP_VARIANT(T, P, V, K)                                              \
  if (vectors == V && keys == K)                                            \
    return static_cast<int>(launch<T, P, V, K>(                             \
        q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, k_amax, v_amax,  \
        block_tables, q_start, q_len, out, B, C, KV, G, D, bs, nb, rows, kt, \
        smem, device, s));
#define FP_PAIR(T, P)   \
  FP_VARIANT(T, P, 64, 32) \
  FP_VARIANT(T, P, 32, 64) \
  FP_VARIANT(T, P, 32, 32)
  if (dtype == 0 && pool_dtype == 0) {
    FP_PAIR(float, float)
  } else if (dtype == 1 && pool_dtype == 1) {
    FP_PAIR(__nv_bfloat16, __nv_bfloat16)
  }
#undef FP_PAIR
#undef FP_VARIANT
  return static_cast<int>(cudaErrorInvalidValue);
}
