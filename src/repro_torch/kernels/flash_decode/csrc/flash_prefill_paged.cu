// Chunked prefill over a paged KV cache: the commit, the commit then the
// attention, and the attention's default launch variant (64 query vectors
// a block, key tiles of up to 64 rows) for every (q, pool) pair.  The
// kernels, their design and their numerics are in flash_prefill_paged.cuh;
// flash_prefill_variants.cu holds the tuner's other variants.

#include "flash_prefill_paged.cuh"

// The (q, pool) dtype pairs with an instantiation; dtype / pool_dtype: 0 =
// float32, 1 = bfloat16, 2 = int8.  Any other pair returns an
// invalid-value code.
#define FP_DISPATCH(CALL)                                            \
  if (dtype == 0 && pool_dtype == 0)                                 \
    return static_cast<int>(CALL(float, float));                     \
  if (dtype == 0 && pool_dtype == 1)                                 \
    return static_cast<int>(CALL(float, __nv_bfloat16));             \
  if (dtype == 0 && pool_dtype == 2)                                 \
    return static_cast<int>(CALL(float, int8_t));                    \
  if (dtype == 1 && pool_dtype == 1)                                 \
    return static_cast<int>(CALL(__nv_bfloat16, __nv_bfloat16));     \
  if (dtype == 1 && pool_dtype == 2)                                 \
    return static_cast<int>(CALL(__nv_bfloat16, int8_t));            \
  return static_cast<int>(cudaErrorInvalidValue)

// Launches the commit, then the attention, on ``stream``.  k_scale and
// v_scale are NULL unless the pools are int8; k_amax and v_amax (B, C) are
// NULL unless the caller gives each row's amax for int8 pools.  rows (chunk
// rows a block, rows * G <= 64), kt (key rows a tile, <= 64) and smem (the
// attention block's dynamic shared memory in bytes, as laid out above its
// kernel) come from the caller's plan (kernel.prefill_plan).  Returns the
// first cudaGetLastError() that is not 0 (0 when both launches were
// accepted); never synchronises.
extern "C" int flash_prefill_paged_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* k_amax,
    const void* v_amax, const void* block_tables, const void* q_start,
    const void* q_len, void* out, int B, int C, int KV, int G, int D, int bs,
    int nb, int rows, int kt, int smem, int dtype, int pool_dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP_LAUNCH(T, P)                                                    \
  launch<T, P, 64, 64>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, \
                       k_amax, v_amax, block_tables, q_start, q_len, out, B, \
                       C, KV, G, D, bs, nb, rows, kt, smem, device, s)
  FP_DISPATCH(FP_LAUNCH);
#undef FP_LAUNCH
}

// The commit alone (a decode step's row is a chunk of one): k/v_new (B, C,
// KV, D) into the pools, and scales for int8 pools (from k_amax/v_amax
// when they are not NULL), on ``stream``.
extern "C" int flash_commit_paged_launch(
    const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    void* k_scale, void* v_scale, const void* k_amax, const void* v_amax,
    const void* block_tables,
    const void* q_start, const void* q_len, int B, int C, int KV, int D,
    int bs, int nb, int dtype, int pool_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP_COMMIT(T, P)                                                    \
  commit<T, P>(k_new, v_new, k_pool, v_pool, k_scale, v_scale, k_amax,     \
               v_amax, block_tables, q_start, q_len, B, C, KV, D, bs, nb, s)
  FP_DISPATCH(FP_COMMIT);
#undef FP_COMMIT
}

