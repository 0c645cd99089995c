// One 5-point Jacobi sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/jacobi2d/kernel.py::jacobi_step
// (_jacobi_kernel): out = u on the outermost ring (Dirichlet boundary), and
// 0.25 * (north + south + west + east) inside.  The TPU kernel's rolls at
// its row-tile edges exist only because its tiles sit in VMEM; here each
// thread reads its four neighbours straight from u.
//
// Bound: bytes.  One thread per point, a warp along a row: the four
// neighbour reads of a block hit lines its own and its neighbours' rows
// already brought into L1/L2, so HBM sees about one read of u and one write
// of out per point (2N words), at 4 flops a point.
//
// Numerics: computed in fp32, ((n + s) + w) + e then times 0.25, each step
// rounded (__fadd_rn/__fmul_rn), the order of jacobi2d/ref.py, so fp32
// results equal the reference's bit for bit; bf16 is widened and rounded
// once at the store.  Any H and W: points past the grid are masked, and a
// grid with H or W below 3 is all boundary, copied through.
//
// Launch variants: the kernel is a template over TILE_H, the rows of its
// 32-wide block.  jacobi2d.cu instantiates the default, 32 x 8;
// jacobi2d_variants.cu the tuner's 32 x 4, 32 x 16 and 32 x 32.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int kTileW = 32;  // one warp along a row
constexpr int kMaxGridY = 65535;

template <typename T, int TILE_H>
__global__ void __launch_bounds__(kTileW * TILE_H)
jacobi_kernel(const T *__restrict__ u, T *__restrict__ out, int H, int W) {
  const int j = blockIdx.x * kTileW + threadIdx.x;
  if (j >= W) return;
  for (int i = blockIdx.y * TILE_H + threadIdx.y; i < H;
       i += gridDim.y * TILE_H) {
    const int64_t idx = (int64_t)i * W + j;
    if (i == 0 || i == H - 1 || j == 0 || j == W - 1) {
      out[idx] = u[idx];
      continue;
    }
    const float n = Cvt<T>::in(u[idx - W]);
    const float s = Cvt<T>::in(u[idx + W]);
    const float w = Cvt<T>::in(u[idx - 1]);
    const float e = Cvt<T>::in(u[idx + 1]);
    out[idx] = Cvt<T>::out(
        __fmul_rn(0.25f, __fadd_rn(__fadd_rn(__fadd_rn(n, s), w), e)));
  }
}

template <typename T, int TILE_H>
int launch(const void *u, void *out, int H, int W, cudaStream_t stream) {
  const int rows = (H + TILE_H - 1) / TILE_H;
  const dim3 grid((W + kTileW - 1) / kTileW, rows < kMaxGridY ? rows : kMaxGridY);
  jacobi_kernel<T, TILE_H><<<grid, dim3(kTileW, TILE_H), 0, stream>>>(
      static_cast<const T *>(u), static_cast<T *>(out), H, W);
  return (int)cudaGetLastError();
}

// The dtype switch of one TILE_H variant.
template <int TILE_H>
int launch_variant(const void *u, void *out, int H, int W, int dtype,
                   cudaStream_t stream) {
  if (H <= 0 || W <= 0) return 0;
  switch (dtype) {
    case 0: return launch<float, TILE_H>(u, out, H, W, stream);
    case 1: return launch<__nv_bfloat16, TILE_H>(u, out, H, W, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char *jacobi2d_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
