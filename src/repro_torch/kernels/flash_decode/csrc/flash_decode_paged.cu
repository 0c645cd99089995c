// Flash-decode for Hopper (sm_90a): the C interface of the library.  The
// kernel, its contracts and its design are in flash_decode_paged.cuh; its
// instantiations are in flash_decode_<q>_<pool>.cu (paged, one dtype pair
// each) and flash_decode_contiguous.cu, compiled beside this file and
// linked into one library.
//
// C interface (loaded with ctypes):
//   int flash_decode_paged_launch(...);   the paged launch, below
//   int flash_decode_launch(...);         the contiguous launch, below
//   const char *flash_decode_error_string(int code);

#include "flash_decode_paged.cuh"

// dtype / pool_dtype: 0 = float32, 1 = bfloat16, 2 = int8.  Each returns
// cudaGetLastError() after the launch (0 when the launch was accepted, an
// invalid-value code for a pair that has no instantiation, a head range
// outside the pools, a split that is not whole table blocks, missing
// scratch, or commit arguments out of pairs); never synchronises.  The
// paged launch attends the KV heads of q (B, KV, G, D) over pool heads
// head0 .. head0 + KV - 1 of pools whose rows hold pool_kv heads.
// partial: B * KV * splits * G * (D + 2) floats and counters: B * KV * G
// ints, zero, where splits = ceil(nb * bs / split_rows) > 1; the kernel
// leaves the counters zero.  With k_new and v_new ((B, KV, D) in q's
// dtype) it first commits slot b's new row at position valid_len[b] - 1
// through its table, as flash_commit_paged_launch with q_len 1 and q_start
// valid_len - 1 would (k_amax/v_amax (B,) fp32 or NULL, int8 pools only),
// writing the pools and scales in place.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* valid_len, void* out, void* partial, void* counters,
    const void* k_new, const void* v_new, const void* k_amax,
    const void* v_amax, int B, int KV, int G, int D, int bs, int nb,
    int pool_kv, int head0, int split_rows, int dtype, int pool_dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const FdPagedArgs a{q, k_pool, v_pool, k_scale, v_scale, block_tables,
                      valid_len, out, partial, counters, k_new, v_new,
                      k_amax, v_amax, B, KV, G, D, bs, nb, pool_kv, head0,
                      split_rows, static_cast<cudaStream_t>(stream)};
  if (dtype == 0 && pool_dtype == 0)
    return static_cast<int>(fd_paged_f32_f32(a));
  if (dtype == 0 && pool_dtype == 1)
    return static_cast<int>(fd_paged_f32_bf16(a));
  if (dtype == 0 && pool_dtype == 2)
    return static_cast<int>(fd_paged_f32_int8(a));
  if (dtype == 1 && pool_dtype == 1)
    return static_cast<int>(fd_paged_bf16_bf16(a));
  if (dtype == 1 && pool_dtype == 2)
    return static_cast<int>(fd_paged_bf16_int8(a));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The contiguous cache k/v (B, S, KV, D) in q's dtype (0 or 1), in splits
// of split_rows rows; partial and counters as for the paged launch with S
// in place of nb * bs.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* valid_len,
                                   void* out, void* partial, void* counters,
                                   int B, int KV, int G, int D, int S,
                                   int split_rows, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(fd_contiguous_f32(q, k, v, valid_len, out,
                                              partial, counters, B, KV, G, D,
                                              S, split_rows, st));
  if (dtype == 1)
    return static_cast<int>(fd_contiguous_bf16(q, k, v, valid_len, out,
                                               partial, counters, B, KV, G,
                                               D, S, split_rows, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
