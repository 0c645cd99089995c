// Block-ELL SpMV for Hopper (sm_90a), predicated and fixed-width.
//
// Replaces the TPU kernels src/repro/kernels/spmv/kernel.py::spmv_blockell
// (_spmv_kernel) and ::spmv_fixed_width: y[r] = sum_j values[r, j] *
// x[col_idx[r, j]], over the lanes j < row_nnz[r] (predicated) or over the
// whole padded width (fixed width), with the paper's synthetic repeat loop:
// the row sum is added `repeat` times, each time scaled by 1/repeat.
//
// What bounds it on an H100: the bytes of the live values and column
// indices (HBM), and the gathers of x, one 32-byte L2 request each: x (4 MB
// at 2^20 columns) stays in the 50 MB L2, but random 4-byte gathers mostly
// miss L1.  At the paper's problem the gathers bound it (below); the HBM
// stream of values and columns, which shares the L2 with them, adds about
// a fifth.
//
// Design (the plan, kernel.spmv_plan, picks the instantiation):
//   * a row is read by a group of LANES lanes, each loading VEC elements at
//     once (16 bytes of values: 4 fp32 or 8 bf16, and their VEC column
//     indices), so a warp holds 32 / LANES rows, and each lane carries
//     kUnroll rows: a warp takes 32 / LANES * kUnroll neighbouring rows.
//     Predicated, one pass of a row covers kPredSpan elements (8 lanes of 4
//     fp32, 4 of 8 bf16), above the mean row_nnz of the paper's problem;
//     fixed width, up to kFixedLanes lanes cover the padded row in one pass;
//   * the row_nnz of a warp's rows are one coalesced load, then shuffles;
//     each pass issues every vector load of the lane's rows, then every
//     gather, then every FMA, so a lane has kUnroll * VEC gathers in
//     flight; values and columns are streamed past L1 (L1::no_allocate),
//     x read through the non-coherent path, so L1 keeps x;
//   * a row's lanes are summed by shuffles within their group; lane 0 of
//     the group runs the repeat loop and stores y.
// What the design cannot remove: the kernel's gathers alone (the probe
// below) run at about 135 G a second on an H100, whatever the lanes, rows
// a lane, occupancy, L1 policy or grid shape, so they set its floor: the
// predicated kernel takes about 1.2x its probe, the fixed-width one about
// 1.12x.
// Widths that are not a multiple of VEC, and values or col_idx that are not
// 16-byte aligned, take the scalar instantiation (VEC 1, 32 lanes a row).
//
// Predication: a vector that lies wholly at or past row_nnz[r] is never
// loaded; one that straddles it is loaded whole, but its lanes at or past
// row_nnz[r] neither gather x nor add (a NaN there stays out of the sum).
// row_nnz below 0 counts as 0, above width as width.  Fixed width loads,
// gathers and adds every lane of the padded width: it is the paper's
// fixed-width strawman, and skipping its padding would stop it measuring
// what it stands for.
//
// Numerics: products and lane sums in fp32 (bf16 widened), the repeat loop
// loop-carried (`#pragma unroll 1`, acc = acc + rowsum * inv, each step
// rounded), with inv = 1/repeat already rounded to the values' dtype, as
// the TPU kernel does; y is rounded to the values' dtype once.  The sum
// runs in another order than the reference's, so results agree within a
// tolerance, not bit for bit.
//
// The gather probe (spmv_gather_probe_launch) is the fp32 kernel with its
// values and column indices replaced by ones and by a hash of (row, lane)
// onto [0, n_cols): the same gathers, in the same layout, with no HBM
// stream beside them, so its time is the floor the L2 gathers set.
//
// C interface (loaded with ctypes):
//   int spmv_launch(const void *values, const int *col_idx,
//                   const int *row_nnz, const void *x, void *y,
//                   long long rows, int width, int repeat, float inv,
//                   int predicated, int dtype, int vec, int lanes,
//                   int unroll, cudaStream_t stream);
//   int spmv_gather_probe_launch(const int *row_nnz, const float *x,
//                   float *y, long long rows, int width, int n_cols,
//                   int predicated, int lanes, cudaStream_t stream);
//   dtype: 0 fp32, 1 bf16; (vec, lanes, unroll) must name an instantiation
//   (the plan's), else cudaErrorInvalidValue; every col_idx entry that is
//   read must be a column of x (not checked: it lives on the device).
//   const char *spmv_error_string(int code);

#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// predicated: elements one pass of a row covers (lanes * VEC)
constexpr int kPredSpan = 32;
// fixed width: lanes a row, at most (at least 8 for the vector routes)
constexpr int kFixedLanes = 32;
// rows a lane carries, vector and scalar instantiations
constexpr int kUnroll = 4;
constexpr int kUnrollScalar = 4;
// blocks an SM for __launch_bounds__: 85 registers a thread.  The kernel
// is bound by the L2's rate of gathers, not by latency: on an H100 full
// occupancy (8 blocks, 32 registers, spilling) took 1.5x as long and no
// minimum (64 registers) 1% longer (tools/spmv_variants.py)
constexpr int kMinBlocks = 3;

// a load that streams past L1 (L1::no_allocate), so that L1 keeps x
__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}
__device__ __forceinline__ uint32_t ld_stream(const uint32_t* p) {
  uint32_t r;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(r) : "l"(p));
  return r;
}
__device__ __forceinline__ uint16_t ld_stream(const uint16_t* p) {
  uint16_t r;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(r) : "l"(p));
  return r;
}

// VEC consecutive elements of T from p, widened to fp32
template <typename T, int VEC>
__device__ __forceinline__ void load_values(const T* p, float* f) {
  if constexpr (VEC == 1) {
    if constexpr (sizeof(T) == 4) {
      f[0] = __uint_as_float(ld_stream(reinterpret_cast<const uint32_t*>(p)));
    } else {
      f[0] = __uint_as_float(
          uint32_t(ld_stream(reinterpret_cast<const uint16_t*>(p))) << 16);
    }
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector is 16 bytes of values");
    const uint4 r = ld_stream(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = __uint_as_float(w[i]);
    } else {  // bf16: element 2i in the low half of word i
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// VEC consecutive column indices from p
template <int VEC>
__device__ __forceinline__ void load_cols(const int* p, int* c) {
  if constexpr (VEC == 1) {
    c[0] = static_cast<int>(ld_stream(reinterpret_cast<const uint32_t*>(p)));
  } else {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const uint4 r = ld_stream(reinterpret_cast<const uint4*>(p) + i);
      c[4 * i] = r.x;
      c[4 * i + 1] = r.y;
      c[4 * i + 2] = r.z;
      c[4 * i + 3] = r.w;
    }
  }
}

// the gather probe's column of element i of the flattened (rows, width)
// matrix: a 32-bit mix of i scaled onto [0, n_cols); kernel.py's
// ref.probe_columns computes the same
__device__ __forceinline__ int probe_col(uint32_t i, uint32_t n_cols) {
  uint32_t h = i * 0x9E3779B1u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return static_cast<int>((static_cast<uint64_t>(h) * n_cols) >> 32);
}

// One warp takes kRows * UNROLL neighbouring rows: row (u, group) is
// first + u * kRows + group, read by the group's LANES lanes.  kProbe: the
// gather probe (fp32; values are ones, columns probe_col).
template <typename T, int VEC, int LANES, int UNROLL, bool kPred,
          bool kProbe>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    spmv_kernel(const T* __restrict__ values,
                const int* __restrict__ col_idx,
                const int* __restrict__ row_nnz, const T* __restrict__ x,
                T* __restrict__ y, int64_t rows, int width, int repeat,
                float inv, uint32_t n_cols) {
  constexpr int kRows = 32 / LANES;  // rows a warp holds at once
  constexpr int kSpan = LANES * VEC;  // elements one pass of a row covers
  constexpr int kWarpRows = kRows * UNROLL;
  static_assert(kWarpRows <= 32, "a warp's row_nnz are one load");
  const int lane = threadIdx.x & 31;
  const int group = lane / LANES;
  const int sub = lane - group * LANES;
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kWarpRows;
  if (first >= rows) return;  // whole warps

  int limit[UNROLL];
  int nnz = width;
  if (kPred) {
    nnz = 0;
    if (lane < kWarpRows && first + lane < rows)
      nnz = static_cast<int>(
          ld_stream(reinterpret_cast<const uint32_t*>(row_nnz + first) +
                    lane));
    nnz = nnz < 0 ? 0 : (nnz < width ? nnz : width);
  }
  int most = 0;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int src = u * kRows + group;
    limit[u] = kPred ? __shfl_sync(0xffffffffu, nnz, src) : width;
    if (first + src >= rows) limit[u] = 0;  // rows past the end: nothing
    most = max(most, limit[u]);
  }
  most = __reduce_max_sync(0xffffffffu, most);

  float sum[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) sum[u] = 0.f;
  // warp-uniform passes; a lane's vector starts at j
  for (int base = 0; base < most; base += kSpan) {
    const int j = base + sub * VEC;
    float v[UNROLL][VEC] = {};
    int c[UNROLL][VEC] = {};
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t off = (first + u * kRows + group) * width + j;
      if (kProbe) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[u][e] = 1.f;
          c[u][e] = probe_col(static_cast<uint32_t>(off + e), n_cols);
        }
      } else if (j < limit[u]) {  // a vector wholly past limit: not loaded
        load_values<T, VEC>(values + off, v[u]);
        load_cols<VEC>(col_idx + off, c[u]);
      }
    }
    float g[UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        g[u][e] = j + e < limit[u] ? Cvt<T>::in(__ldg(x + c[u][e])) : 0.f;
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
#pragma unroll
      for (int e = 0; e < VEC; ++e)  // a dead lane adds nothing, not 0 * v
        sum[u] = j + e < limit[u] ? fmaf(v[u][e], g[u][e], sum[u]) : sum[u];
  }

#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
    for (int off = LANES / 2; off > 0; off >>= 1)
      sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], off);
  }
  if (sub == 0) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t row = first + u * kRows + group;
      if (row >= rows) break;
      float acc = 0.f;
#pragma unroll 1
      for (int k = 0; k < repeat; ++k)
        acc = __fadd_rn(acc, __fmul_rn(sum[u], inv));
      y[row] = Cvt<T>::out(acc);
    }
  }
}

template <typename T, int VEC, int LANES, int UNROLL, bool kPred,
          bool kProbe = false>
cudaError_t run(const void* values, const int* col_idx, const int* row_nnz,
                const void* x, void* y, int64_t rows, int width, int repeat,
                float inv, uint32_t n_cols, cudaStream_t stream) {
  constexpr int64_t kBlockRows = int64_t(kWarps) * (32 / LANES) * UNROLL;
  const int64_t blocks = (rows + kBlockRows - 1) / kBlockRows;
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
  spmv_kernel<T, VEC, LANES, UNROLL, kPred, kProbe>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(
          static_cast<const T*>(values), col_idx, row_nnz,
          static_cast<const T*>(x), static_cast<T*>(y), rows, width, repeat,
          inv, n_cols);
  return cudaGetLastError();
}

// the instantiations the plan may name, for one dtype: predicated
// (kPredSpan / VEC lanes), fixed width (8, 16 or kFixedLanes lanes), and
// the scalar route (32 lanes) of either
template <typename T>
cudaError_t dispatch(const void* values, const int* col_idx,
                     const int* row_nnz, const void* x, void* y,
                     int64_t rows, int width, int repeat, float inv,
                     bool predicated, int vec, int lanes, int unroll,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPredLanes = kPredSpan / kVec;
#define SPMV_RUN(VEC, LANES, UNROLL, PRED)                             \
  return run<T, VEC, LANES, UNROLL, PRED>(values, col_idx, row_nnz, x, y, \
                                          rows, width, repeat, inv, 0,    \
                                          stream)
  if (vec == 1 && lanes == 32 && unroll == kUnrollScalar) {
    if (predicated) SPMV_RUN(1, 32, kUnrollScalar, true);
    SPMV_RUN(1, 32, kUnrollScalar, false);
  }
  if (vec == kVec && unroll == kUnroll) {
    if (predicated && lanes == kPredLanes)
      SPMV_RUN(kVec, kPredLanes, kUnroll, true);
    if (!predicated && lanes == kFixedLanes)
      SPMV_RUN(kVec, kFixedLanes, kUnroll, false);
    if (!predicated && lanes == 16) SPMV_RUN(kVec, 16, kUnroll, false);
    if (!predicated && lanes == 8) SPMV_RUN(kVec, 8, kUnroll, false);
  }
#undef SPMV_RUN
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int spmv_launch(const void* values, const int* col_idx,
                           const int* row_nnz, const void* x, void* y,
                           long long rows, int width, int repeat, float inv,
                           int predicated, int dtype, int vec, int lanes,
                           int unroll, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (width < 1) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(values, col_idx, row_nnz, x, y, rows, width,
                                  repeat, inv, predicated, vec, lanes,
                                  unroll, stream);
    case 1:
      return (int)dispatch<__nv_bfloat16>(values, col_idx, row_nnz, x, y,
                                          rows, width, repeat, inv,
                                          predicated, vec, lanes, unroll,
                                          stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The gather probe, fp32, in the vector layout of the fp32 plan (lanes:
// the plan's lanes a row; width a multiple of 4): y[r] = sum over the
// row's live lanes j of x[probe_col(r * width + j)].
extern "C" int spmv_gather_probe_launch(const int* row_nnz, const float* x,
                                        float* y, long long rows, int width,
                                        int n_cols, int predicated,
                                        int lanes, cudaStream_t stream) {
  if (rows <= 0) return 0;
  if (width < 1 || width % 4 || n_cols < 1) return (int)cudaErrorInvalidValue;
  const uint32_t n = static_cast<uint32_t>(n_cols);
  if (predicated && lanes == kPredSpan / 4)
    return (int)run<float, 4, kPredSpan / 4, kUnroll, true, true>(
        nullptr, nullptr, row_nnz, x, y, rows, width, 1, 1.f, n, stream);
#define SPMV_PROBE(LANES)                                                 \
  return (int)run<float, 4, LANES, kUnroll, false, true>(                 \
      nullptr, nullptr, row_nnz, x, y, rows, width, 1, 1.f, n, stream)
  if (!predicated && lanes == kFixedLanes) SPMV_PROBE(kFixedLanes);
  if (!predicated && lanes == 16) SPMV_PROBE(16);
  if (!predicated && lanes == 8) SPMV_PROBE(8);
#undef SPMV_PROBE
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
