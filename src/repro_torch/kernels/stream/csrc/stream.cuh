// STREAM copy / scale / add / triad for Hopper (sm_90a), one kernel body.
//
// Replaces the TPU kernel src/repro/kernels/stream/kernel.py::_call (the
// pallas_call behind stream_copy, stream_scale, stream_add and
// stream_triad): c = a, c = q*a, c = a + b, c = a + q*b over a row-tiled
// (rows, width) array.  On the TPU q was a compile-time constant; here it is
// an argument and the op is a template parameter.
//
// Bound: bytes.  Each element is read once per input and written once, with
// no reuse, so the kernel only has to keep enough bytes in flight to fill
// HBM.  Where a, b and c are 16-byte aligned, each thread issues UNROLL
// independent 16-byte loads per input (4 fp32 or 8 16-bit values each)
// before its first store, and the grid covers the vectors once, a block
// THREADS * UNROLL of them (256 x 4 by default), with no grid-stride loop.
// On the H100 this came closest to PyTorch's copy and add among the variants tried (128,
// 256 or 512 threads; 1, 2, 4 or 8 vectors a thread; one pass or a
// grid-stride loop of 4 or 8 waves; evict-first loads and stores (__ldcs,
// __stcs) or ld.global.nc.L1::no_allocate, all slower than plain loads and
// stores).
// The misaligned arrays and the tail take one element a thread in a
// grid-stride loop, sized from the SM count, read once per device.
//
// Numerics: each op rounds to the arrays' dtype as the oracle
// (stream/ref.py) does: 16-bit values are widened to fp32, and a result is
// rounded to nearest even at the store.  q arrives already rounded to the
// arrays' dtype.  The triad rounds q*b to the dtype, then a + that, with
// __fmul_rn/__fadd_rn so nvcc cannot contract it into one FMA: results
// equal the oracle's bit for bit in every dtype.
//
// Launch variants: the vector kernel is a template over its threads a
// block and its vectors a thread.  stream.cu instantiates the default, 256
// threads of 4 vectors; stream_variants.cu the tuner's other eight of
// {128, 256, 512} threads x {2, 4, 8} vectors.  The one-element kernel of
// the tail keeps 256 threads in every variant.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int kThreads = 256;  // the one-element kernel's block
constexpr int kBlocksPerSM = 8;
constexpr int kMaxDevices = 64;

enum Op { kCopy = 0, kScale = 1, kAdd = 2, kTriad = 3 };

template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b, float q) {
  if (OP == kCopy) return a;
  const float fa = Cvt<T>::in(a);
  float r;
  if (OP == kScale) {
    r = __fmul_rn(fa, q);
  } else if (OP == kAdd) {
    r = __fadd_rn(fa, Cvt<T>::in(b));
  } else {
    const float qb = Cvt<T>::in(Cvt<T>::out(__fmul_rn(q, Cvt<T>::in(b))));
    r = __fadd_rn(fa, qb);
  }
  return Cvt<T>::out(r);
}

// nvec 16-byte vectors of a, b, c; block x takes vectors
// [x * THREADS * UNROLL, (x + 1) * THREADS * UNROLL), thread t those
// at t, t + THREADS, ... of its block's, so each load is coalesced.
template <typename T, int OP, int THREADS, int UNROLL>
__global__ void __launch_bounds__(THREADS)
stream_vec_kernel(const uint4 *__restrict__ a, const uint4 *__restrict__ b,
                  uint4 *__restrict__ c, float q, int64_t nvec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr bool kTwo = OP == kAdd || OP == kTriad;
  const int64_t first =
      (int64_t)blockIdx.x * THREADS * UNROLL + threadIdx.x;
  uint4 va[UNROLL], vb[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = first + u * THREADS;
    if (i < nvec) {
      va[u] = a[i];
      if (kTwo) vb[u] = b[i];
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = first + u * THREADS;
    if (i >= nvec) break;
    if (OP == kCopy) {
      c[i] = va[u];
      continue;
    }
    uint4 vc;
    const T *ea = reinterpret_cast<const T *>(&va[u]);
    const T *eb = reinterpret_cast<const T *>(kTwo ? &vb[u] : &va[u]);
    T *ec = reinterpret_cast<T *>(&vc);
#pragma unroll
    for (int k = 0; k < kVec; ++k) ec[k] = apply<T, OP>(ea[k], eb[k], q);
    c[i] = vc;
  }
}

// elements [begin, n) one a thread.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
stream_scalar_kernel(const T *__restrict__ a, const T *__restrict__ b,
                     T *__restrict__ c, float q, int64_t begin, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = begin + (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const T bi = (OP == kAdd || OP == kTriad) ? b[i] : a[i];
    c[i] = apply<T, OP>(a[i], bi, q);
  }
}

// Blocks of the one-element kernel: at most kBlocksPerSM a multiprocessor.
int grid_for(int64_t work) {
  static int sms[kMaxDevices] = {};
  int device = 0;
  cudaGetDevice(&device);
  int &count = sms[device < kMaxDevices ? device : 0];
  if (count == 0 &&
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess)
    count = 132;
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)count * kBlocksPerSM;
  return (int)(need < cap ? need : cap);
}

bool aligned16(const void *p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <typename T, int OP, int THREADS, int UNROLL>
int launch(const void *a, const void *b, void *c, int64_t n, float q,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  int64_t done = 0;
  if (aligned16(a) && aligned16(b) && aligned16(c)) {
    const int64_t nvec = n / kVec;
    if (nvec > 0) {
      const int64_t per_block = THREADS * UNROLL;
      stream_vec_kernel<T, OP, THREADS, UNROLL>
          <<<(nvec + per_block - 1) / per_block, THREADS, 0, stream>>>(
          static_cast<const uint4 *>(a), static_cast<const uint4 *>(b),
          static_cast<uint4 *>(c), q, nvec);
      done = nvec * kVec;
    }
  }
  if (done < n) {
    stream_scalar_kernel<T, OP><<<grid_for(n - done), kThreads, 0, stream>>>(
        static_cast<const T *>(a), static_cast<const T *>(b),
        static_cast<T *>(c), q, done, n);
  }
  return (int)cudaGetLastError();
}

template <typename T, int THREADS, int UNROLL>
int launch_op(const void *a, const void *b, void *c, int64_t n, int op,
              float q, cudaStream_t stream) {
  switch (op) {
    case kCopy: return launch<T, kCopy, THREADS, UNROLL>(a, b, c, n, q, stream);
    case kScale:
      return launch<T, kScale, THREADS, UNROLL>(a, b, c, n, q, stream);
    case kAdd: return launch<T, kAdd, THREADS, UNROLL>(a, b, c, n, q, stream);
    case kTriad:
      return launch<T, kTriad, THREADS, UNROLL>(a, b, c, n, q, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The dtype switch of one (THREADS, UNROLL) variant.
template <int THREADS, int UNROLL>
int launch_variant(const void *a, const void *b, void *c, long long n,
                   int op, float q, int dtype, cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (dtype) {
    case 0: return launch_op<float, THREADS, UNROLL>(a, b, c, n, op, q, stream);
    case 1:
      return launch_op<__nv_bfloat16, THREADS, UNROLL>(a, b, c, n, op, q,
                                                       stream);
    case 2:
      return launch_op<__half, THREADS, UNROLL>(a, b, c, n, op, q, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" const char *stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
