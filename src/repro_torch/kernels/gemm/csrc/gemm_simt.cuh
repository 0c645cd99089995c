// GEMM, route "simt", for Hopper (sm_90a): C = A @ B on the CUDA cores, for
// fp32 and for bf16 that TMA cannot address (gemm_wgmma.cu takes the rest).
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py::gemm
// (_gemm_kernel): (M, K) @ (K, N) with an fp32 accumulator and one flush,
// cast to the inputs' dtype.  The TPU walked K as the sequential, innermost
// grid axis and kept the accumulator in VMEM scratch; here each block owns
// one 128 x 128 tile of C, keeps its accumulator in registers (8 x 8 values
// a thread) and walks K in a loop of 16-deep slices.
//
// Bound: operations (2MNK flops; an 8192^3 fp32 product is 1.1 TFLOP against
// 0.8 GB moved, 16.4 ms at the 67 TFLOP/s fp32 peak).  TF32 stays off (the
// reference's product is full fp32), so fp32 has no tensor-core path; the
// design keeps the FMA pipes busy:
// - 8 warps a block in 2 x 4, each a 64 x 32 warp tile; a lane holds 2 x 2
//   sub-tiles of 4 x 4 (rows r..r+3 and r+32..r+35, columns c..c+3 and
//   c+16..c+19), so each 16-deep step reads its 8 A and 8 B values as four
//   16-byte shared loads (LDS.128) for 64 FMAs, free of bank conflicts
//   (lanes of one A read share an address; B reads are contiguous).
// - Two shared stages: the next slice's global loads are issued into
//   registers before this slice's FMAs and stored to the other stage after
//   them, so they fly under the arithmetic, with one __syncthreads a slice.
// - A's slice is stored k-major (As[k][m]): a thread loads 8 consecutive k
//   of one row, and a warp's 32 rows store to 32 consecutive words.  B's
//   slice keeps its layout: a thread loads 8 consecutive columns of one k.
//   Rows are loaded as 16-byte vectors where kernel.gemm_plan allows it
//   (vec_a, vec_b: the operand aligned and its row length a multiple of the
//   vector), element by element otherwise; C is stored as 4-element vectors
//   when N % 4 == 0 (vec_c).  When every tile lies inside M, N and K and
//   both operands are read as vectors (whole_tiles), an instantiation
//   without any edge check runs: at 8192^3 the checks' live values cost
//   about 13% of the time at the 128-register cap two blocks an SM allow
//   (PERF.md section 6).
// - Tiles are walked GROUP_M block rows at a time (csrc/gemm_tiles.cuh).
//
// Numerics: products summed in fp32 along K in order, with FMA; bf16 inputs
// are widened on the way into shared memory and C is rounded to bf16 once,
// as preferred_element_type=f32 then astype does.  Any M, N and K: loads
// past an edge read zeros and stores past an edge are dropped.
//
// Launch variants: the kernel is a template over the block tile BM x BN
// (64 x 32 warp tiles, so BM / 64 x BN / 32 warps); each thread loads
// BM * 16 / 8 / threads rows of A's slice and 16 * BN / 8 / threads of B's,
// 8 elements each.  gemm_simt.cu instantiates the default, 128 x 128 (8
// warps, one load of each a thread, the layout above); gemm_simt_variants.cu
// the tuner's 128 x 64 (4 warps) and 64 x 64 (2 warps), for small products
// whose 128 x 128 grid would leave SMs idle.  kernel.py's gemm_plan names
// the variant.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"
#include "gemm_tiles.cuh"

namespace {

constexpr int kBK = 16;
constexpr int kGroupM = 16;
// threads of a BM x BN block: one warp a 64 x 32 warp tile
template <int BM, int BN>
constexpr int kThreads = (BM / 64) * (BN / 32) * 32;

// 8 consecutive elements of a row, widened to fp32: p[0..7], of which the
// first `left` exist (zeros past them; all 8 without EDGES).  VEC: 16-byte
// vectors, each loaded whole or not at all (kernel.gemm_plan takes this
// path only when the row length is a multiple of the vector, so `left` is
// too).  The vectors are unpacked by value, never through a local array's
// address, so they stay in registers.
template <typename T, bool VEC, bool EDGES>
__device__ __forceinline__ void load8(float (&r)[8], const T *p, int left) {
  if constexpr (VEC && sizeof(T) == 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 v = !EDGES || 4 * h < left
                           ? *reinterpret_cast<const float4 *>(p + 4 * h)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      r[4 * h] = v.x;
      r[4 * h + 1] = v.y;
      r[4 * h + 2] = v.z;
      r[4 * h + 3] = v.w;
    }
  } else if constexpr (VEC) {  // 8 bf16: a bf16 is the top half of a float
    const uint4 v = !EDGES || 0 < left
                        ? *reinterpret_cast<const uint4 *>(p)
                        : make_uint4(0, 0, 0, 0);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[2 * i] = __uint_as_float(w[i] << 16);
      r[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = i < left ? Cvt<T>::in(p[i]) : 0.0f;
  }
}

// 4 values to C[0..3] of a row, of which the first `left` exist.
template <typename T>
__device__ __forceinline__ void store4(T *p, float4 v, int left, bool vec) {
  if (vec && left >= 4) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4 *>(p) = v;
    } else {
      *reinterpret_cast<__nv_bfloat162 *>(p) = __floats2bfloat162_rn(v.x, v.y);
      *reinterpret_cast<__nv_bfloat162 *>(p + 2) =
          __floats2bfloat162_rn(v.z, v.w);
    }
  } else {
    if (left > 0) p[0] = Cvt<T>::out(v.x);
    if (left > 1) p[1] = Cvt<T>::out(v.y);
    if (left > 2) p[2] = Cvt<T>::out(v.z);
    if (left > 3) p[3] = Cvt<T>::out(v.w);
  }
}

// EDGES: some tile reaches past M, N or K, so loads and stores are
// checked; without it (kernel.gemm_plan's whole_tiles) none is, which keeps
// the default's loop within the 128 registers two blocks an SM allow.  Every
// variant asks for two blocks an SM: a smaller block then has more
// registers a thread for its second row of loads (at the default's 128
// the 4- and 2-warp variants spilled 28-152 bytes).
template <typename T, int BM, int BN, bool VEC_A, bool VEC_B, bool EDGES>
__global__ void __launch_bounds__(kThreads<BM, BN>, 2)
gemm_simt_kernel(const T *__restrict__ A, const T *__restrict__ B,
                 T *__restrict__ C, int M, int N, int K, bool vec_c) {
  constexpr int kT = kThreads<BM, BN>;
  constexpr int kLA = BM * kBK / 8 / kT, kLB = kBK * BN / 8 / kT;
  static_assert(kLA * 8 * kT == BM * kBK && kLB * 8 * kT == kBK * BN,
                "each thread loads whole rows of 8");
  __shared__ __align__(16) float As[2][kBK][BM];
  __shared__ __align__(16) float Bs[2][kBK][BN];
  int m0, n0;
  gemm_tile_origin<BM, BN, kGroupM>(M, N, m0, n0);
  const int tid = threadIdx.x;
  // loader l: A row a_m, k a_k..a_k+7; B row b_k, columns b_n..b_n+7
  int a_m[kLA], a_k[kLA], a_left[kLA], b_k[kLB], b_n[kLB], b_left[kLB];
  const T *a_src[kLA];
  const T *b_src[kLB];
#pragma unroll
  for (int l = 0; l < kLA; ++l) {
    const int idx = tid + l * kT;
    a_m[l] = idx % BM;
    a_k[l] = (idx / BM) * 8;
    const bool a_row = !EDGES || m0 + a_m[l] < M;
    a_src[l] = A + (int64_t)(a_row ? m0 + a_m[l] : 0) * K + a_k[l];
    a_left[l] = a_row ? K - a_k[l] : 0;  // at k0 = 0
  }
#pragma unroll
  for (int l = 0; l < kLB; ++l) {
    const int idx = tid + l * kT;
    b_k[l] = idx / (BN / 8);
    b_n[l] = (idx % (BN / 8)) * 8;
    b_src[l] = B + b_k[l] * (int64_t)N + n0 + b_n[l];
    b_left[l] = N - n0 - b_n[l];
  }
  // compute: a lane's rows r0..r0+3, r0+32.., columns c0..c0+3, c0+16..
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = (warp / (BN / 32)) * 64 + (lane / 4) * 4;
  const int c0 = (warp % (BN / 32)) * 32 + (lane % 4) * 4;

  float ra[kLA][8], rb[kLB][8];
  auto load = [&](int k0) {
#pragma unroll
    for (int l = 0; l < kLA; ++l)
      load8<T, VEC_A, EDGES>(ra[l], a_src[l] + k0, a_left[l] - k0);
#pragma unroll
    for (int l = 0; l < kLB; ++l)
      load8<T, VEC_B, EDGES>(rb[l], b_src[l] + (int64_t)k0 * N,
                             k0 + b_k[l] < K ? b_left[l] : 0);
  };
  auto store = [&](int s) {
#pragma unroll
    for (int l = 0; l < kLA; ++l)
#pragma unroll
      for (int i = 0; i < 8; ++i) As[s][a_k[l] + i][a_m[l]] = ra[l][i];
#pragma unroll
    for (int l = 0; l < kLB; ++l) {
      *reinterpret_cast<float4 *>(&Bs[s][b_k[l]][b_n[l]]) =
          make_float4(rb[l][0], rb[l][1], rb[l][2], rb[l][3]);
      *reinterpret_cast<float4 *>(&Bs[s][b_k[l]][b_n[l] + 4]) =
          make_float4(rb[l][4], rb[l][5], rb[l][6], rb[l][7]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  const int k_tiles = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < k_tiles; ++t) {
    const int s = t & 1;
    if (t + 1 < k_tiles) load((t + 1) * kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4 *>(&As[s][k][r0]);
      const float4 a1 = *reinterpret_cast<const float4 *>(&As[s][k][r0 + 32]);
      const float4 b0 = *reinterpret_cast<const float4 *>(&Bs[s][k][c0]);
      const float4 b1 = *reinterpret_cast<const float4 *>(&Bs[s][k][c0 + 16]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other stage was last read before the previous __syncthreads
    if (t + 1 < k_tiles) store(s ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + r0 + (i < 4 ? i : 28 + i);
    if (EDGES && row >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + c0 + 16 * h;
      if (!EDGES || col < N)
        store4(C + (int64_t)row * N + col,
               make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                           acc[i][4 * h + 2], acc[i][4 * h + 3]),
               EDGES ? N - col : 4, vec_c);
    }
  }
}

template <typename T, int BM, int BN, bool VEC_A, bool VEC_B, bool EDGES>
int launch(const void *a, const void *b, void *c, int M, int N, int K,
           bool vec_c, int grid, cudaStream_t stream) {
  gemm_simt_kernel<T, BM, BN, VEC_A, VEC_B, EDGES>
      <<<grid, kThreads<BM, BN>, 0, stream>>>(
          static_cast<const T *>(a), static_cast<const T *>(b),
          static_cast<T *>(c), M, N, K, vec_c);
  return (int)cudaGetLastError();
}

template <typename T, int BM, int BN>
int launch(const void *a, const void *b, void *c, int M, int N, int K,
           bool vec_a, bool vec_b, bool vec_c, bool whole, int grid,
           cudaStream_t stream) {
  if (whole)
    return launch<T, BM, BN, true, true, false>(a, b, c, M, N, K, true, grid,
                                                stream);
  if (vec_a && vec_b)
    return launch<T, BM, BN, true, true, true>(a, b, c, M, N, K, vec_c, grid,
                                               stream);
  if (vec_a)
    return launch<T, BM, BN, true, false, true>(a, b, c, M, N, K, vec_c,
                                                grid, stream);
  if (vec_b)
    return launch<T, BM, BN, false, true, true>(a, b, c, M, N, K, vec_c,
                                                grid, stream);
  return launch<T, BM, BN, false, false, true>(a, b, c, M, N, K, vec_c, grid,
                                               stream);
}

// The checks and the dtype switch of one BM x BN variant.
template <int BM, int BN>
int launch_variant(const void *a, const void *b, void *c, int M, int N,
                   int K, int dtype, int vec_a, int vec_b, int vec_c,
                   int whole, int grid, cudaStream_t stream) {
  const int64_t tiles = (int64_t)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  if (M < 1 || N < 1 || K < 1 || grid != tiles ||
      (whole && (M % BM || N % BN || K % kBK || !vec_a || !vec_b)))
    return cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float, BM, BN>(a, b, c, M, N, K, vec_a, vec_b, vec_c,
                                   whole, grid, stream);
    case 1:
      return launch<__nv_bfloat16, BM, BN>(a, b, c, M, N, K, vec_a, vec_b,
                                           vec_c, whole, grid, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char *gemm_simt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
