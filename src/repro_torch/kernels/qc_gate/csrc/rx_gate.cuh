// RX(theta) on one qubit of a state vector, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/qc_gate/kernel.py::rx_gate
// (_rx_kernel): the state is two planes, re and im, of n_amp amplitudes,
// viewed as (outer, 2, inner) with inner = 2^qubit, so amplitude a =
// (o, 0, k) pairs with b = a + inner = (o, 1, k), and
//   re'[a] = c re[a] + s im[b]    im'[a] = c im[a] - s re[b]
//   re'[b] = c re[b] + s im[a]    im'[b] = c im[b] - s re[a]
// with c = cos(theta / 2) and s = sin(theta / 2), rounded to the planes'
// dtype by the caller (JAX's weak typing of the TPU kernel's Python float
// constants).
//
// Bound: bytes.  Each amplitude of both planes is read once and written
// once (4 * n_amp * sizeof(T) bytes) for 6 flops an amplitude.
//
// Design: one thread per amplitude pair i in [0, n_amp / 2), a =
// ((i >> q) << (q + 1)) | (i & (inner - 1)), b = a + inner, in a
// grid-stride loop with 64-bit indices.  No shared memory: the TPU
// kernel's (block_outer, 2, inner) tiles exist for VMEM.  For q >= 5 a
// warp's a (and b) are 32 consecutive amplitudes; below, the warp's a and
// b interleave within the same 128-byte lines, so either way each byte
// should come from device memory once (the timings at qubits 0, 5, 13 and
// 27 in chip_smoke.py test this).
//
// Numerics: each product, sum and difference is rounded to T, as
// arithmetic in T rounds (__fmul_rn / __fadd_rn / __fsub_rn keep nvcc from
// contracting them into FMAs, and Cvt<T> rounds to nearest even), so the
// kernel equals qc_gate/ref.py::rx_plain bit for bit in fp32 and bf16.
//
// Launch variants: the kernel is a template over its threads a block.
// rx_gate.cu instantiates the default, 256; rx_gate_variants.cu the tuner's
// 128, 512 and 1024.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int64_t kMaxBlocks = 1 << 20;

// x rounded to T and widened back (the identity for float)
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return Cvt<T>::in(Cvt<T>::out(x));
}

// round(round(c * x) +- round(s * y)) in T: plus for kPlus, else minus
template <typename T, bool kPlus>
__device__ __forceinline__ T mix(float c, float x, float s, float y) {
  const float p = rnd<T>(__fmul_rn(c, x));
  const float q = rnd<T>(__fmul_rn(s, y));
  return Cvt<T>::out(kPlus ? __fadd_rn(p, q) : __fsub_rn(p, q));
}

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
rx_gate_kernel(const T *__restrict__ re, const T *__restrict__ im,
               T *__restrict__ ore, T *__restrict__ oim, int64_t pairs,
               int q, float c, float s) {
  const int64_t low = (int64_t(1) << q) - 1;
  const int64_t stride = int64_t(gridDim.x) * THREADS;
  for (int64_t i = int64_t(blockIdx.x) * THREADS + threadIdx.x; i < pairs;
       i += stride) {
    const int64_t a = ((i >> q) << (q + 1)) | (i & low);
    const int64_t b = a + low + 1;
    const float re0 = Cvt<T>::in(re[a]), re1 = Cvt<T>::in(re[b]);
    const float im0 = Cvt<T>::in(im[a]), im1 = Cvt<T>::in(im[b]);
    ore[a] = mix<T, true>(c, re0, s, im1);
    oim[a] = mix<T, false>(c, im0, s, re1);
    ore[b] = mix<T, true>(c, re1, s, im0);
    oim[b] = mix<T, false>(c, im1, s, re0);
  }
}

template <typename T, int THREADS>
int launch(const void *re, const void *im, void *ore, void *oim,
           int64_t n_amp, int q, float c, float s, cudaStream_t stream) {
  const int64_t pairs = n_amp / 2;
  int64_t blocks = (pairs + THREADS - 1) / THREADS;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  rx_gate_kernel<T, THREADS>
      <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T *>(re), static_cast<const T *>(im),
      static_cast<T *>(ore), static_cast<T *>(oim), pairs, q, c, s);
  return (int)cudaGetLastError();
}

// The checks and the dtype switch of one THREADS variant.
template <int THREADS>
int launch_variant(const void *re, const void *im, void *ore, void *oim,
                   long long n_amp, int qubit, float c, float s, int dtype,
                   cudaStream_t stream) {
  if (qubit < 0 || qubit > 62 || n_amp < 2) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return launch<float, THREADS>(re, im, ore, oim, n_amp, qubit, c, s,
                                    stream);
    case 1:
      return launch<__nv_bfloat16, THREADS>(re, im, ore, oim, n_amp, qubit,
                                            c, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char *rx_gate_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
