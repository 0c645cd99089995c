// Flash-decode's paged launches for a f32 q over bf16 pools: 24 kernels (D
// 16-128 x 1, 2 or 4 query heads a block, with and without the commit),
// a translation unit of their own so that nvcc compiles the library's
// dtype pairs at once (flash_decode_paged.cuh, "Build").

#include "flash_decode_paged.cuh"

cudaError_t fd_paged_f32_bf16(const FdPagedArgs& a) {
  return launch_paged<float, __nv_bfloat16>(a);
}
