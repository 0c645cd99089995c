// Paged flash-decode for Hopper (sm_90a): attention of one query token per
// serving slot over that slot's KV cache, read through its block table.
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py ::
// flash_decode_paged (body _decode_kernel_paged), for f32 and bf16 pools
// without scales and without head sharding.
//
// Contract (that of the TPU kernel):
//   q            (B, KV, G, D)            f32 or bf16
//   k_pool/v_pool (n_blocks, bs, KV, D)   same dtype as q
//   block_tables (B, nb) int32            logical block -> pool block
//   valid_len    (B,) int32, >= 1         live rows of each slot
//   out          (B, KV, G, D)            dtype of q
// Row t of slot b lives at pool block block_tables[b, t / bs], row t % bs.
// Rows at or past valid_len[b] are never read.
//
// What bounds it on an H100: the bytes of the live K and V rows,
// sum_b valid_len[b] * KV * D * 2 * sizeof(T), over 3.35 TB/s.  The
// arithmetic, 4 * G * D flops per live row and head, is far below what the
// card computes in that time.  At serving sizes (a few hundred live rows per
// slot) those bytes take about a microsecond, so one launch is bound by the
// launch latency instead.
//
// Design, simple first:
//   * one thread block per (KV head, slot): all heads of all slots run in
//     parallel, and no reduction crosses blocks;
//   * the block loads its own block-table row into shared memory and walks
//     only the logical blocks j < ceil(valid_len / bs), the TPU kernel's
//     skip of tiles past the live length;
//   * each warp reads whole K rows, lanes on consecutive elements
//     (coalesced), and the G query heads of the KV head share every K and V
//     row it reads;
//   * running max, sum and accumulator stay in fp32; the output is written
//     in q's dtype.
// Left for later: wgmma/TMA, splitting long contexts across blocks, and
// removing the launch latency by capturing the whole decode step in a CUDA
// graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Shared memory, in floats: q (G*D), acc (G*D), p (G*bs), m, l, corr (G
// each), then the block-table row (nb ints).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_decode_paged_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ valid_len,
                              T* __restrict__ out, int KV, int G, int bs,
                              int nb) {
  constexpr int kPerLane = D / 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc = q_s + G * D;
  float* p_s = acc + G * D;
  float* m_s = p_s + G * bs;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  int* table = reinterpret_cast<int*>(c_s + G);

  const int valid = min(valid_len[b], nb * bs);
  const int n_tiles = valid > 0 ? (valid + bs - 1) / bs : 0;
  const float scale = rsqrtf(static_cast<float>(D));

  const T* q_head = q + (static_cast<size_t>(b) * KV + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    q_s[i] = to_float(q_head[i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  for (int j = tid; j < n_tiles; j += kThreads)
    table[j] = block_tables[static_cast<size_t>(b) * nb + j];
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(KV) * D;
  for (int j = 0; j < n_tiles; ++j) {
    const int rows = min(bs, valid - j * bs);
    // element offset of row 0, head h, of this pool block
    const size_t base =
        (static_cast<size_t>(table[j]) * bs * KV + h) * static_cast<size_t>(D);

    // scores: one warp per K row, all G query heads at once
    for (int r = warp; r < rows; r += kWarps) {
      const T* k_row = k_pool + base + r * row_stride;
      float kr[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e) kr[e] = to_float(k_row[lane + 32 * e]);
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          s += q_s[g * D + lane + 32 * e] * kr[e];
        s = warp_sum(s);
        if (lane == 0) p_s[g * bs + r] = s * scale;
      }
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[g * bs + r]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(p_s[g * bs + r] - m_new);
        p_s[g * bs + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V: one thread per (query head, element)
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const T* v_col = v_pool + base + d;
      float a = acc[i] * c_s[g];
      for (int r = 0; r < rows; ++r)
        a += p_s[g * bs + r] * to_float(v_col[r * row_stride]);
      acc[i] = a;
    }
    __syncthreads();
  }

  T* o_head = out + (static_cast<size_t>(b) * KV + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    o_head[i] = from_float<T>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* block_tables, const void* valid_len, void* out,
                   int B, int KV, int G, int D, int bs, int nb,
                   cudaStream_t stream) {
  const dim3 grid(KV, B);
  const size_t smem =
      sizeof(float) * (2 * G * D + G * bs + 3 * G) + sizeof(int) * nb;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_pool);
  const T* vt = static_cast<const T*>(v_pool);
  const int* bt = static_cast<const int*>(block_tables);
  const int* vl = static_cast<const int*>(valid_len);
  T* ot = static_cast<T*>(out);
  if (D == 64) {
    flash_decode_paged_kernel<T, 64><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, bt, vl, ot, KV, G, bs, nb);
  } else if (D == 128) {
    flash_decode_paged_kernel<T, 128><<<grid, kThreads, smem, stream>>>(
        qt, kt, vt, bt, vl, ot, KV, G, bs, nb);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (0 when the launch was accepted); never synchronises.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* valid_len, void* out, int B,
    int KV, int G, int D, int bs, int nb, int dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k_pool, v_pool, block_tables,
                                          valid_len, out, B, KV, G, D, bs,
                                          nb, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, k_pool, v_pool, block_tables, valid_len, out, B, KV, G, D, bs, nb,
        s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
