// STREAM copy / scale / add / triad for Hopper (sm_90a), one kernel body.
//
// Replaces the TPU kernel src/repro/kernels/stream/kernel.py::_call (the
// pallas_call behind stream_copy, stream_scale, stream_add and
// stream_triad): c = a, c = q*a, c = a + b, c = a + q*b over a row-tiled
// (rows, width) array.  On the TPU q was a compile-time constant; here it is
// an argument and the op is a template parameter.
//
// Bound: bytes.  Each element is read once per input and written once, with
// no reuse, so the kernel only has to keep enough loads in flight to fill
// HBM: a grid-stride loop over 16-byte vectors (4 fp32 or 8 16-bit values)
// where a, b and c are 16-byte aligned, and one element a thread otherwise
// and for the tail.
//
// Numerics: each op rounds to the arrays' dtype as the oracle
// (stream/ref.py) does: 16-bit values are widened to fp32, and a result is
// rounded to nearest even at the store.  q arrives already rounded to the
// arrays' dtype.  The triad rounds q*b to the dtype, then a + that, with
// __fmul_rn/__fadd_rn so nvcc cannot contract it into one FMA: results
// equal the oracle's bit for bit in every dtype.
//
// C interface (loaded with ctypes):
//   int stream_launch(const void *a, const void *b, void *c, long long n,
//                     int op, float q, int dtype, cudaStream_t stream);
//   op: 0 copy, 1 scale, 2 add, 3 triad; dtype: 0 fp32, 1 bf16, 2 fp16;
//   b is read by add and triad only.  Returns a cudaError_t code.
//   const char *stream_error_string(int code);

#include <cuda_runtime.h>
#include <stdint.h>

#include "convert.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSM = 8;

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

// nvec 16-byte vectors of a, b, c.
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
stream_vec_kernel(const uint4 *__restrict__ a, const uint4 *__restrict__ b,
                  uint4 *__restrict__ c, float q, int64_t nvec) {
  constexpr int kVec = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < nvec;
       i += stride) {
    const uint4 va = a[i];
    if (OP == kCopy) {
      c[i] = va;
      continue;
    }
    const uint4 vb = (OP == kAdd || OP == kTriad) ? b[i] : make_uint4(0, 0, 0, 0);
    uint4 vc;
    const T *ea = reinterpret_cast<const T *>(&va);
    const T *eb = reinterpret_cast<const T *>(&vb);
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

int grid_for(int64_t work) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t need = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * kBlocksPerSM;
  return (int)(need < cap ? need : cap);
}

bool aligned16(const void *p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <typename T, int OP>
int launch(const void *a, const void *b, void *c, int64_t n, float q,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  int64_t done = 0;
  if (aligned16(a) && aligned16(b) && aligned16(c)) {
    const int64_t nvec = n / kVec;
    if (nvec > 0) {
      stream_vec_kernel<T, OP><<<grid_for(nvec), kThreads, 0, stream>>>(
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

template <typename T>
int launch_op(const void *a, const void *b, void *c, int64_t n, int op,
              float q, cudaStream_t stream) {
  switch (op) {
    case kCopy: return launch<T, kCopy>(a, b, c, n, q, stream);
    case kScale: return launch<T, kScale>(a, b, c, n, q, stream);
    case kAdd: return launch<T, kAdd>(a, b, c, n, q, stream);
    case kTriad: return launch<T, kTriad>(a, b, c, n, q, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int stream_launch(const void *a, const void *b, void *c,
                             long long n, int op, float q, int dtype,
                             cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (dtype) {
    case 0: return launch_op<float>(a, b, c, n, op, q, stream);
    case 1: return launch_op<__nv_bfloat16>(a, b, c, n, op, q, stream);
    case 2: return launch_op<__half>(a, b, c, n, op, q, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char *stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
