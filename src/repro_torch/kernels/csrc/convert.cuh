// Widening to fp32 and rounding back (to nearest even) for the element
// types the port's kernels take: Cvt<T>::in(x) is float(x), Cvt<T>::out(f)
// is f rounded to T.  Shared by the kernel sources that include it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

template <typename T> struct Cvt;
template <> struct Cvt<float> {
  static __device__ __forceinline__ float in(float x) { return x; }
  static __device__ __forceinline__ float out(float x) { return x; }
};
template <> struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float in(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 out(float x) {
    return __float2bfloat16_rn(x);
  }
};
template <> struct Cvt<__half> {
  static __device__ __forceinline__ float in(__half x) { return __half2float(x); }
  static __device__ __forceinline__ __half out(float x) { return __float2half_rn(x); }
};
