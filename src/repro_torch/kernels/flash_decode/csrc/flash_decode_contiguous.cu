// Flash-decode's contiguous launches, f32 and bf16: 24 kernels (D 16-128 x
// 1, 2 or 4 query heads a block), a translation unit of their own so that
// nvcc compiles them beside the paged dtype pairs (flash_decode_paged.cuh,
// "Build").

#include "flash_decode_paged.cuh"

cudaError_t fd_contiguous_f32(const void* q, const void* k, const void* v,
                              const void* valid_len, void* out,
                              void* partial, void* counters, int B, int KV,
                              int G, int D, int S, int split_rows,
                              cudaStream_t stream) {
  return launch_contiguous<float>(q, k, v, valid_len, out, partial, counters,
                                  B, KV, G, D, S, split_rows, stream);
}

cudaError_t fd_contiguous_bf16(const void* q, const void* k, const void* v,
                               const void* valid_len, void* out,
                               void* partial, void* counters, int B, int KV,
                               int G, int D, int S, int split_rows,
                               cudaStream_t stream) {
  return launch_contiguous<__nv_bfloat16>(q, k, v, valid_len, out, partial,
                                          counters, B, KV, G, D, S,
                                          split_rows, stream);
}
