// Block-ELL SpMV for Hopper (sm_90a), predicated and fixed-width.
//
// Replaces the TPU kernels src/repro/kernels/spmv/kernel.py::spmv_blockell
// (_spmv_kernel) and ::spmv_fixed_width: y[r] = sum_j values[r, j] *
// x[col_idx[r, j]], over the lanes j < row_nnz[r] (predicated) or over the
// whole padded width (fixed width), with the paper's synthetic repeat loop:
// the row sum is added `repeat` times, each time scaled by 1/repeat.
//
// Bound: bytes.  One warp per row; its lanes stride over the row, so each
// pass of the warp reads 32 neighbouring values and column indices, then a
// shuffle reduction sums the lanes.  Predicated, a lane at or past row_nnz
// loads neither value nor column: that is the predication, which on the
// card shows as fewer bytes where on SVE it showed as fewer instructions.
// Fixed width loads every lane.  The gathered x (4 MB at 2^20 columns)
// stays in L2.
//
// Numerics: products and lane sums in fp32 (bf16 widened), the repeat loop
// loop-carried (`#pragma unroll 1`, acc = acc + rowsum * inv, each step
// rounded), with inv = 1/repeat already rounded to the values' dtype, as
// the TPU kernel does; y is rounded to the values' dtype once.  The sum
// runs in another order than the reference's, so results agree within a
// tolerance, not bit for bit.
//
// C interface (loaded with ctypes):
//   int spmv_launch(const void *values, const int *col_idx,
//                   const int *row_nnz, const void *x, void *y,
//                   long long rows, int width, int repeat, float inv,
//                   int predicated, int dtype, cudaStream_t stream);
//   dtype: 0 fp32, 1 bf16; every col_idx entry that is read must be a
//   column of x (not checked: it lives on the device).
//   const char *spmv_error_string(int code);

#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int kWarps = 8;  // rows per block
constexpr int kThreads = 32 * kWarps;

template <typename T, bool kPredicated>
__global__ void __launch_bounds__(kThreads)
spmv_kernel(const T *__restrict__ values, const int *__restrict__ col_idx,
            const int *__restrict__ row_nnz, const T *__restrict__ x,
            T *__restrict__ y, int64_t rows, int width, int repeat,
            float inv) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warps: a warp shares its row
  int limit = width;
  if (kPredicated) {
    const int nnz = row_nnz[row];
    limit = nnz < 0 ? 0 : (nnz < width ? nnz : width);
  }
  const T *v = values + row * width;
  const int *c = col_idx + row * width;
  float sum = 0.0f;
  for (int j = lane; j < limit; j += 32) {
    sum = fmaf(Cvt<T>::in(v[j]), Cvt<T>::in(x[c[j]]), sum);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (lane == 0) {
    float acc = 0.0f;
#pragma unroll 1
    for (int k = 0; k < repeat; ++k) acc = __fadd_rn(acc, __fmul_rn(sum, inv));
    y[row] = Cvt<T>::out(acc);
  }
}

template <typename T>
int launch(const void *values, const int *col_idx, const int *row_nnz,
           const void *x, void *y, int64_t rows, int width, int repeat,
           float inv, int predicated, cudaStream_t stream) {
  const int64_t blocks = (rows + kWarps - 1) / kWarps;
  const T *v = static_cast<const T *>(values);
  const T *xx = static_cast<const T *>(x);
  T *yy = static_cast<T *>(y);
  if (predicated) {
    spmv_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        v, col_idx, row_nnz, xx, yy, rows, width, repeat, inv);
  } else {
    spmv_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        v, col_idx, row_nnz, xx, yy, rows, width, repeat, inv);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int spmv_launch(const void *values, const int *col_idx,
                           const int *row_nnz, const void *x, void *y,
                           long long rows, int width, int repeat, float inv,
                           int predicated, int dtype, cudaStream_t stream) {
  if (rows <= 0) return 0;
  switch (dtype) {
    case 0: return launch<float>(values, col_idx, row_nnz, x, y, rows, width,
                                 repeat, inv, predicated, stream);
    case 1: return launch<__nv_bfloat16>(values, col_idx, row_nnz, x, y, rows,
                                         width, repeat, inv, predicated,
                                         stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char *spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
