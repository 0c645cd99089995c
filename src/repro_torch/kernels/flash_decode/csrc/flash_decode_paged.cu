// Flash-decode for Hopper (sm_90a): attention of one query token per
// serving slot over that slot's KV cache, read through its block table
// (paged) or in place from a contiguous (B, S, KV, D) cache.
//
// Replaces two TPU kernels of src/repro/kernels/flash_decode/kernel.py:
//   * flash_decode_paged (body _decode_kernel_paged), for pools in q's
//     dtype, bf16 pools under an f32 q (widened, :140-142) and int8 pools
//     with per-row fp32 scales (the quantized branch, :120-139), with its
//     head_shard=(i, n) slice (:207-218): the grid covers KV / n heads
//     and reads the full pools from head i * KV / n on, at the pools' own
//     row stride, so the head slice is never copied.  The same body is the
//     per-device kernel of flash_decode_paged_sharded (:264), which runs
//     it on each rank's local pools from head 0;
//   * flash_decode (body _decode_kernel), the contiguous cache.  The TPU
//     wrapper makes a head-major copy of K and V first (kernel.py:87-88);
//     this kernel reads (B, S, KV, D) in place with a row stride of KV * D.
// One body serves both: the template flag kPaged picks table or stride
// addressing of a tile's first row, and nothing else differs.
//
// Paged contract (that of the TPU kernel flash_decode_paged):
//   q            (B, KV, G, D)            T: f32 or bf16; KV is the
//                                         grid's (local) head count
//   k_pool/v_pool (n_blocks, bs, pool_kv, D)  P: T, bf16 under an f32 T,
//                                         or int8 under either; head h of
//                                         q reads pool head head0 + h
//   k_scale/v_scale (n_blocks, bs) f32    int8 pools only: one scale a
//                                         pool row, over all its KV heads
//   block_tables (B, nb) int32            logical block -> pool block
//   valid_len    (B,) int32, >= 1         live rows of each slot
//   out          (B, KV, G, D)            dtype of q
// Row t of slot b lives at pool block block_tables[b, t / bs], row t % bs.
// Unsharded, pool_kv = KV and head0 = 0.
// Rows at or past valid_len[b], and their scales, are never read.  An int8
// element is dequantized to fp32 at load as code * scale, as the TPU
// kernel widens its tile in VMEM; a bf16 pool element is widened to fp32.
//
// Contiguous contract (that of the TPU kernel flash_decode):
//   q            (B, KV, G, D)            f32 or bf16
//   k/v          (B, S, KV, D)            same dtype as q
//   valid_len    (B,) int32               live rows of each slot; a slot
//                                         with valid_len <= 0 gives zeros,
//                                         as the TPU kernel's clamped l does
//   out          (B, KV, G, D)            dtype of q
// Row t of slot b lives at k[b, t]; the kernel walks tiles of bs rows and
// issues none past valid_len[b] (the TPU kernel's predicated block skip).
//
// Head dims 16, 32, 64 and 128: a warp reads a K row with D / 32 elements
// a lane, or one element a lane below D = 32, the lanes at or past D
// loading nothing and adding nothing (predicated lanes).
//
// What bounds it on an H100: the bytes of the live K and V rows,
// sum_b valid_len[b] * (KV * D * 2 * sizeof(P) + 8 bytes of scales when
// P is int8), over 3.35 TB/s.  The
// arithmetic, 4 * G * D flops per live row and head, is far below what the
// card computes in that time.  At serving sizes (a few hundred live rows per
// slot) those bytes take about a microsecond, so one launch is bound by the
// launch latency instead.
//
// Design, simple first:
//   * one thread block per (KV head, slot): all heads of all slots run in
//     parallel, and no reduction crosses blocks;
//   * paged, the block loads its own block-table row into shared memory,
//     and with int8 pools each tile's K and V scales before the tile;
//     either way it walks only the tiles j < ceil(valid_len / bs), the TPU
//     kernel's skip of tiles past the live length;
//   * each warp reads whole K rows, lanes on consecutive elements
//     (coalesced), and the G query heads of the KV head share every K and V
//     row it reads;
//   * running max, sum and accumulator stay in fp32, and p stays fp32 in
//     the p @ V product (decode_ref's arithmetic; the TPU kernel rounds p
//     to V's dtype first, kernel.py:59); the output is written in q's
//     dtype.
// B * KV blocks on 132 SMs: 4 at the registry's example, 256 to 384 at
// 32 slots of gpt2-124m or qwen3-1.7b heads, each walking its slot's
// tiles in series.
// Left for later: wgmma/TMA, splitting long contexts across blocks, and
// removing the launch latency by capturing the whole decode step in a CUDA
// graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
}

// A pool element widened to fp32: code * scale for int8 pools (P = int8),
// the element itself otherwise (scale unused).  It takes the loaded value,
// not a pointer, so each load is made through the kernel's __restrict__
// pointers, as read-only loads.
template <typename P>
__device__ __forceinline__ float dequant(P x, float scale) {
  if constexpr (std::is_same_v<P, int8_t>)
    return to_float(x) * scale;
  else
    return to_float(x);
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
// each), with int8 pools the tile's K and V scales (bs each), then, paged,
// the block-table row (nb ints).  Paged, k/v are the pools (n_blocks, bs,
// KV, D) and a slot holds nb * bs rows; contiguous, k/v are (B, S, KV, D),
// block_tables is unused and a slot holds S rows.
template <typename T, typename P, int D, bool kPaged>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                        const P* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ valid_len,
                        T* __restrict__ out, int KV, int G, int bs, int nb,
                        int S, int pool_kv, int head0) {
  constexpr bool kQuant = std::is_same_v<P, int8_t>;
  // elements of a K row per lane; below D = 32 the lanes >= D idle
  constexpr int kPerLane = (D + 31) / 32;
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
  float* ks_s = c_s + G;                 // int8 pools only
  float* vs_s = ks_s + (kQuant ? bs : 0);
  int* table = reinterpret_cast<int*>(vs_s + (kQuant ? bs : 0));

  const int valid = min(valid_len[b], kPaged ? nb * bs : S);
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
  if (kPaged)
    for (int j = tid; j < n_tiles; j += kThreads)
      table[j] = block_tables[static_cast<size_t>(b) * nb + j];
  __syncthreads();

  // a row of the pools (or of the contiguous cache) holds pool_kv heads;
  // this block reads head head0 + h of each
  const size_t row_stride = static_cast<size_t>(pool_kv) * D;
  for (int j = 0; j < n_tiles; ++j) {
    const int rows = min(bs, valid - j * bs);
    // element offset of the tile's row 0, head h: in its pool block, or
    // row j * bs of slot b
    const size_t first = kPaged ? static_cast<size_t>(table[j]) * bs
                                : static_cast<size_t>(b) * S + j * bs;
    const size_t base =
        (first * pool_kv + head0 + h) * static_cast<size_t>(D);
    if constexpr (kQuant) {  // the live rows' scales, none past valid
      for (int r = tid; r < rows; r += kThreads) {
        ks_s[r] = k_scale[first + r];
        vs_s[r] = v_scale[first + r];
      }
      __syncthreads();
    }

    // scores: one warp per K row, all G query heads at once
    for (int r = warp; r < rows; r += kWarps) {
      const P* k_row = k_pool + base + r * row_stride;
      const float ks = kQuant ? ks_s[r] : 1.f;
      float kr[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        kr[e] = (D >= 32 || lane < D) ? dequant(k_row[lane + 32 * e], ks)
                                      : 0.f;
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          if (D >= 32 || lane < D) s += q_s[g * D + lane + 32 * e] * kr[e];
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
      const P* v_col = v_pool + base + d;
      float a = acc[i] * c_s[g];
      for (int r = 0; r < rows; ++r)
        a += p_s[g * bs + r] *
             dequant(v_col[r * row_stride], kQuant ? vs_s[r] : 1.f);
      acc[i] = a;
    }
    __syncthreads();
  }

  T* o_head = out + (static_cast<size_t>(b) * KV + h) * G * D;
  for (int i = tid; i < G * D; i += kThreads)
    o_head[i] = from_float<T>(acc[i] / fmaxf(l_s[i / D], 1e-30f));
}

template <typename T, typename P, bool kPaged, int D>
void launch_d(const dim3 grid, size_t smem, cudaStream_t stream,
              const void* q, const void* k, const void* v,
              const float* k_scale, const float* v_scale,
              const void* block_tables, const void* valid_len, void* out,
              int KV, int G, int bs, int nb, int S, int pool_kv,
              int head0) {
  flash_decode_kernel<T, P, D, kPaged><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(k),
      static_cast<const P*>(v), k_scale, v_scale,
      static_cast<const int*>(block_tables),
      static_cast<const int*>(valid_len), static_cast<T*>(out), KV, G, bs,
      nb, S, pool_kv, head0);
}

// Paged: nb table entries of bs rows; contiguous: nb = 0, tiles of bs rows
// over S.  The grid covers KV heads, heads head0 .. head0 + KV - 1 of rows
// of pool_kv heads.
template <typename T, typename P, bool kPaged>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const void* block_tables, const void* valid_len, void* out,
                   int B, int KV, int G, int D, int bs, int nb, int S,
                   int pool_kv, int head0, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same_v<P, int8_t>;
  if (kQuant && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  if (head0 < 0 || head0 + KV > pool_kv) return cudaErrorInvalidValue;
  const dim3 grid(KV, B);
  const size_t smem =
      sizeof(float) * (2 * G * D + G * bs + 3 * G + (kQuant ? 2 * bs : 0)) +
      sizeof(int) * nb;
  switch (D) {
    case 16:
      launch_d<T, P, kPaged, 16>(grid, smem, stream, q, k, v, k_scale,
                                 v_scale, block_tables, valid_len, out, KV, G,
                                 bs, nb, S, pool_kv, head0);
      break;
    case 32:
      launch_d<T, P, kPaged, 32>(grid, smem, stream, q, k, v, k_scale,
                                 v_scale, block_tables, valid_len, out, KV, G,
                                 bs, nb, S, pool_kv, head0);
      break;
    case 64:
      launch_d<T, P, kPaged, 64>(grid, smem, stream, q, k, v, k_scale,
                                 v_scale, block_tables, valid_len, out, KV, G,
                                 bs, nb, S, pool_kv, head0);
      break;
    case 128:
      launch_d<T, P, kPaged, 128>(grid, smem, stream, q, k, v, k_scale,
                                  v_scale, block_tables, valid_len, out, KV,
                                  G, bs, nb, S, pool_kv, head0);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype / pool_dtype: 0 = float32, 1 = bfloat16, 2 = int8.  Each returns
// cudaGetLastError() after the launch (0 when the launch was accepted, an
// invalid-value code for a pair that has no instantiation or a head range
// outside the pools); never synchronises.  The paged launch attends the KV
// heads of q (B, KV, G, D) over pool heads head0 .. head0 + KV - 1 of
// pools whose rows hold pool_kv heads.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* valid_len, void* out, int B, int KV, int G, int D, int bs,
    int nb, int pool_kv, int head0, int dtype, int pool_dtype, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
#define FD_PAGED(T, P)                                                      \
  return static_cast<int>(launch<T, P, true>(q, k_pool, v_pool, ks, vs,     \
                                             block_tables, valid_len, out,  \
                                             B, KV, G, D, bs, nb, 0,        \
                                             pool_kv, head0, st))
  if (dtype == 0 && pool_dtype == 0) FD_PAGED(float, float);
  if (dtype == 0 && pool_dtype == 1) FD_PAGED(float, __nv_bfloat16);
  if (dtype == 0 && pool_dtype == 2) FD_PAGED(float, int8_t);
  if (dtype == 1 && pool_dtype == 1) FD_PAGED(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 1 && pool_dtype == 2) FD_PAGED(__nv_bfloat16, int8_t);
#undef FD_PAGED
  return static_cast<int>(cudaErrorInvalidValue);
}

// The contiguous cache k/v (B, S, KV, D) in q's dtype (0 or 1), walked in
// tiles of ``tile`` rows.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* valid_len,
                                   void* out, int B, int KV, int G, int D,
                                   int S, int tile, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float, float, false>(
        q, k, v, nullptr, nullptr, nullptr, valid_len, out, B, KV, G, D,
        tile, 0, S, KV, 0, st));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, nullptr, nullptr, nullptr, valid_len, out, B, KV, G, D,
        tile, 0, S, KV, 0, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
