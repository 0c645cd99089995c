// GEMM for Hopper (sm_90a): C = A @ B, shared-memory tiled, on the CUDA
// cores.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py::gemm
// (_gemm_kernel): (M, K) @ (K, N) with an fp32 accumulator and one flush,
// cast to the inputs' dtype.  The TPU walked K as the sequential, innermost
// grid axis and kept the accumulator in VMEM scratch; here each block owns
// one 128 x 128 tile of C, keeps its accumulator in registers (8 x 8 values
// a thread) and walks K in a loop, staging 8-deep slices of A and B in
// shared memory.
//
// Bound: operations (2MNK flops; an 8192^3 fp32 product is 1.1 TFLOP against
// 0.8 GB moved).  This first version runs fp32 FMAs on the CUDA cores, whose
// peak is 67 TFLOP/s; it does not use the tensor cores (wgmma), TMA or a
// pipelined load, which are later work.  Thread (tx, ty) of the 16 x 16
// block computes rows ty + 16i and columns tx + 16j, so its shared-memory
// reads are broadcasts (A) or 16 consecutive words (B), free of bank
// conflicts.
//
// Numerics: products summed in fp32 along K in order, with FMA; bf16 inputs
// are widened on the way into shared memory and C is rounded to bf16 once,
// as preferred_element_type=f32 then astype does.  Any M, N and K: loads
// past an edge read zeros and stores past an edge are dropped.
//
// C interface (loaded with ctypes):
//   int gemm_launch(const void *a, const void *b, void *c, int M, int N,
//                   int K, int dtype, cudaStream_t stream);
//   row-major A (M, K), B (K, N), C (M, N); dtype: 0 fp32, 1 bf16.
//   const char *gemm_error_string(int code);

#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 8;
constexpr int kT = 16;  // threads per block side
constexpr int kTM = kBM / kT, kTN = kBN / kT;  // 8 x 8 outputs a thread
constexpr int kThreads = kT * kT;
constexpr int kMaxGridY = 65535;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_kernel(const T *__restrict__ A, const T *__restrict__ B,
            T *__restrict__ C, int M, int N, int K) {
  // A's slice is stored k-major (As[k][m]); +4 keeps its stores conflict-free
  __shared__ float As[kBK][kBM + 4];
  __shared__ float Bs[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % kT, ty = tid / kT;
  const int n0 = blockIdx.x * kBN;
  for (int m0 = blockIdx.y * kBM; m0 < M; m0 += gridDim.y * kBM) {
    float acc[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int m = e / kBK, k = e % kBK;
        const int gm = m0 + m, gk = k0 + k;
        As[k][m] = (gm < M && gk < K) ? Cvt<T>::in(A[(int64_t)gm * K + gk]) : 0.0f;
      }
#pragma unroll
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int k = e / kBN, n = e % kBN;
        const int gk = k0 + k, gn = n0 + n;
        Bs[k][n] = (gk < K && gn < N) ? Cvt<T>::in(B[(int64_t)gk * N + gn]) : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float a[kTM], b[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) a[i] = As[k][ty + kT * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) b[j] = Bs[k][tx + kT * j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      const int gm = m0 + ty + kT * i;
      if (gm >= M) continue;
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int gn = n0 + tx + kT * j;
        if (gn < N) C[(int64_t)gm * N + gn] = Cvt<T>::out(acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch(const void *a, const void *b, void *c, int M, int N, int K,
           cudaStream_t stream) {
  const int rows = (M + kBM - 1) / kBM;
  const dim3 grid((N + kBN - 1) / kBN, rows < kMaxGridY ? rows : kMaxGridY);
  gemm_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T *>(a), static_cast<const T *>(b),
      static_cast<T *>(c), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int gemm_launch(const void *a, const void *b, void *c, int M,
                           int N, int K, int dtype, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  switch (dtype) {
    case 0: return launch<float>(a, b, c, M, N, K, stream);
    case 1: return launch<__nv_bfloat16>(a, b, c, M, N, K, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char *gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
