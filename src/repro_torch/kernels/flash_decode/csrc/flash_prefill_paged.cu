// Chunked prefill over a paged KV cache for Hopper (sm_90a): commit a
// chunk of K/V rows per serving slot into that slot's pool blocks, then
// causal attention of every chunk row over its slot's cache, read through
// its block table.
//
// Replaces both passes of the TPU kernel
// src/repro/kernels/flash_decode/kernel.py :: flash_prefill_paged: the
// commit (pallas_call at :573, bodies _prefill_commit_kernel and, for int8
// pools, _prefill_commit_kernel_q with _quantize_rows_kernel) and the
// attention (pallas_call at :620, body _prefill_attn_kernel, with its
// dequantizing branch).  Under tensor parallelism each rank runs both on
// its local KV heads.
//
// Contract (that of the TPU kernel, with zeros for the rows it leaves
// undefined):
//   q             (B, C, KV, G, D)       T: f32 or bf16
//   k_new/v_new   (B, C, KV, D)          T
//   k_pool/v_pool (n_blocks, bs, KV, D)  P: T, bf16 under an f32 T, or
//                                        int8 under either; written in
//                                        place
//   k_scale/v_scale (n_blocks, bs) f32   int8 pools only, written in place
//   block_tables  (B, nb) int32          logical block -> pool block
//   q_start/q_len (B,) int32             rows c < q_len[b] of slot b sit
//                                        at positions q_start[b] + c
//   k_amax/v_amax (B, C) f32 or NULL     int8 pools only: each row's amax
//                                        over all KV heads, given by the
//                                        caller (a tensor-parallel rank
//                                        holds only some heads of a row)
//   out           (B, C, KV, G, D)       dtype of q
// Row c < q_len[b] is committed at pool block block_tables[b, pos / bs],
// row pos % bs, with pos = q_start[b] + c, and attends to its slot's keys
// at positions <= pos.  An int8 row is quantized as the TPU kernel does:
// s = max(amax / 127, 1e-8) over the row's KV * D elements (or the
// given k_amax/v_amax of the row, which a rank holding KV / n heads gets
// from an all-reduce MAX over the model axis, so its codes and scales
// equal the unsharded commit's head slice bit for bit), codes
// clip(round_half_even(x / s), -127, 127), s stored at the same pool row.
// XLA compiles amax / 127 as amax times the fp32 reciprocal of 127, and so
// does this kernel; x / s is an IEEE division (no --use_fast_math) and
// rintf rounds half to even, so codes and scales are bit-equal to the
// Pallas commit's.  Rows c >= q_len[b] commit nothing and come out as
// zeros; every other pool row keeps its bytes and its scale.  The two
// kernels run on one stream, commit first, so a row sees the rows its own
// chunk committed (as stored: quantized, or rounded to bf16).
//
// What bounds it on an H100: the K and V rows already cached, q_start per
// slot, read once, and the chunk's rows read once (in T) and written once
// (in P, with 8 bytes of scales a row for int8), over 3.35 TB/s, or the
// 4 * G * D * KV flops per (query row, causal key) pair at the tensor
// cores' rate, whichever is larger.  This kernel does its arithmetic in
// fp32 on the CUDA cores (67 TFLOP/s), with a warp reduction per score,
// so at serving sizes it is bound by that arithmetic and its barriers.
//
// Design, simple first:
//   * commit: one thread block per (chunk row, slot).  It converts the
//     row's K and V elements to P, or, for int8, reduces |x| over the row
//     to its amax first (one block reduction each for K and V) and then
//     writes the codes and the scale.  Unlike the TPU commit (grid (B, nb),
//     kernel.py:332) it never reads or rewrites the rest of a block, so
//     blocks no table names keep their bytes without aliasing.  A decode
//     step commits its row through the same kernel, as a chunk of one
//     (flash_commit_paged_launch), so decode and chunk rows are converted
//     or quantized by one code path;
//   * attend: one thread block per (KV head, slot, tile of bc chunk rows):
//     the decode kernel (flash_decode_paged.cu) with bc * G query vectors
//     and a per-row causal frontier.  The block loads the tile's queries
//     (as fp32) and its table row into shared memory and walks only the
//     logical blocks j < ceil((q_start + last row + 1) / bs), the TPU
//     kernel's skip of tiles past the causal frontier (kernel.py:449);
//   * one warp per K row computes that key's scores for every query
//     vector of the tile; each V tile is staged once in shared memory as
//     fp32 and read by all query vectors; int8 K and V are dequantized at
//     load with the tile's scales, staged in shared memory beside it;
//   * running max, sum and accumulator stay in fp32; the output is written
//     in q's dtype;
//   * head dims 16, 32, 64 and 128: below D = 32 a K row takes one element
//     a lane and the lanes at or past D load nothing (predicated lanes).
// Left for later: wgmma/TMA tiles, splitting long prefixes across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCommitThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(int8_t x) {
  return static_cast<float>(x);
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// max over the block of each thread's v; every thread gets it.  red holds
// kCommitThreads / 32 floats.
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < kCommitThreads / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is reused by the next call
  return m;
}

// One row of n elements from x (in T) to dst (in P): converted, or for
// int8 quantized with a fresh scale written to *scale, from the row's
// amax: *given when the caller passes it, else reduced over the row.
template <typename T, typename P>
__device__ __forceinline__ void commit_row(const T* __restrict__ x,
                                           P* __restrict__ dst,
                                           float* __restrict__ scale, int n,
                                           const float* __restrict__ given,
                                           float* red) {
  if constexpr (std::is_same_v<P, int8_t>) {
    float amax;
    if (given != nullptr) {  // uniform across the block
      amax = *given;
    } else {
      amax = 0.f;
      for (int i = threadIdx.x; i < n; i += kCommitThreads)
        amax = fmaxf(amax, fabsf(to_float(x[i])));
      amax = block_max(amax, red);
    }
    // XLA's amax / 127: the product with 127's fp32 reciprocal
    const float s = fmaxf(amax * (1.f / 127.f), 1e-8f);
    for (int i = threadIdx.x; i < n; i += kCommitThreads) {
      const float c = fminf(fmaxf(rintf(to_float(x[i]) / s), -127.f), 127.f);
      dst[i] = static_cast<int8_t>(c);
    }
    if (threadIdx.x == 0) *scale = s;
  } else {
    for (int i = threadIdx.x; i < n; i += kCommitThreads)
      dst[i] = from_float<P>(to_float(x[i]));
  }
}

// Commits row c of slot b of k_new/v_new (KV * D elements each) to its
// pool row, and for int8 pools its two scales (from k_amax/v_amax[b, c]
// when they are given).  Grid (C, B).
template <typename T, typename P>
__global__ void __launch_bounds__(kCommitThreads)
    prefill_commit_kernel(const T* __restrict__ k_new,
                          const T* __restrict__ v_new, P* __restrict__ k_pool,
                          P* __restrict__ v_pool, float* __restrict__ k_scale,
                          float* __restrict__ v_scale,
                          const float* __restrict__ k_amax,
                          const float* __restrict__ v_amax,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ q_start,
                          const int* __restrict__ q_len, int C, int row,
                          int bs, int nb) {
  __shared__ float red[kCommitThreads / 32];
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  if (c >= q_len[b]) return;  // uniform across the block
  const int pos = q_start[b] + c;
  const int j = min(pos / bs, nb - 1);
  const size_t dst_row =
      static_cast<size_t>(block_tables[static_cast<size_t>(b) * nb + j]) *
          bs + pos % bs;
  const size_t bc = static_cast<size_t>(b) * C + c;
  const size_t src = bc * row;
  constexpr bool kQuant = std::is_same_v<P, int8_t>;
  commit_row(k_new + src, k_pool + dst_row * row,
             kQuant ? k_scale + dst_row : nullptr, row,
             k_amax != nullptr ? k_amax + bc : nullptr, red);
  commit_row(v_new + src, v_pool + dst_row * row,
             kQuant ? v_scale + dst_row : nullptr, row,
             v_amax != nullptr ? v_amax + bc : nullptr, red);
}

// Shared memory, in floats, for R = bc * G query vectors: q (R*D), acc
// (R*D), the V tile (bs*D), p (R*bs), m, l, corr (R each), with int8 pools
// the tile's K and V scales (bs each), then the block-table row (nb ints).
// Grid (KV, B, ceil(C / bc)).
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads)
    prefill_attend_kernel(const T* __restrict__ q,
                          const P* __restrict__ k_pool,
                          const P* __restrict__ v_pool,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ q_start,
                          const int* __restrict__ q_len,
                          T* __restrict__ out, int C, int KV, int G, int bs,
                          int nb, int bc) {
  constexpr bool kQuant = std::is_same_v<P, int8_t>;
  // elements of a K row per lane; below D = 32 the lanes >= D idle
  constexpr int kPerLane = (D + 31) / 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * bc;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int rows_here = min(bc, C - row0);
  const int n_rows = max(0, min(rows_here, min(q_len[b], C) - row0));
  const int GD = G * D;
  const size_t q_row_stride = static_cast<size_t>(KV) * GD;
  const size_t tile_off = ((static_cast<size_t>(b) * C + row0) * KV + h) * GD;

  // rows of this tile at or past q_len come out as zeros
  T* o_tile = out + tile_off;
  for (int i = tid; i < (rows_here - n_rows) * GD; i += kThreads) {
    const int r = n_rows + i / GD;
    o_tile[r * q_row_stride + i % GD] = from_float<T>(0.f);
  }
  if (n_rows == 0) return;  // uniform across the block

  const int R = n_rows * G;
  const int r_max = bc * G;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* acc = q_s + r_max * D;
  float* v_s = acc + r_max * D;
  float* p_s = v_s + bs * D;
  float* m_s = p_s + r_max * bs;
  float* l_s = m_s + r_max;
  float* c_s = l_s + r_max;
  float* ks_s = c_s + r_max;             // int8 pools only
  float* vs_s = ks_s + (kQuant ? bs : 0);
  int* table = reinterpret_cast<int*>(vs_s + (kQuant ? bs : 0));

  // last key position each query vector v may see: start + row0 + v / G
  const int first = q_start[b] + row0;
  const int frontier = min(first + n_rows, nb * bs);
  const int n_tiles = (frontier + bs - 1) / bs;
  const float scale = rsqrtf(static_cast<float>(D));

  const T* q_tile = q + tile_off;
  for (int i = tid; i < R * D; i += kThreads) {
    const int v = i / D;
    const int r = v / G;
    q_s[i] = to_float(q_tile[r * q_row_stride + (v - r * G) * D + i % D]);
    acc[i] = 0.f;
  }
  for (int v = tid; v < R; v += kThreads) {
    m_s[v] = kNegInf;
    l_s[v] = 0.f;
  }
  for (int j = tid; j < n_tiles; j += kThreads)
    table[j] = block_tables[static_cast<size_t>(b) * nb + j];
  __syncthreads();

  const size_t kv_row_stride = static_cast<size_t>(KV) * D;
  for (int j = 0; j < n_tiles; ++j) {
    const int rows = min(bs, frontier - j * bs);
    const size_t blk_row = static_cast<size_t>(table[j]) * bs;
    // element offset of row 0, head h, of this pool block
    const size_t base = (blk_row * KV + h) * static_cast<size_t>(D);
    if constexpr (kQuant) {  // the tile's scales, none past the frontier
      for (int r = tid; r < rows; r += kThreads) {
        ks_s[r] = k_scale[blk_row + r];
        vs_s[r] = v_scale[blk_row + r];
      }
      __syncthreads();
    }

    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D;
      v_s[i] = dequant(v_pool[base + r * kv_row_stride + (i - r * D)],
                       kQuant ? vs_s[r] : 1.f);
    }

    // scores: one warp per K row, every query vector of the tile
    for (int r = warp; r < rows; r += kWarps) {
      const P* k_row = k_pool + base + r * kv_row_stride;
      const float ks = kQuant ? ks_s[r] : 1.f;
      float kr[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        kr[e] = (D >= 32 || lane < D) ? dequant(k_row[lane + 32 * e], ks)
                                      : 0.f;
      const int key = j * bs + r;
      for (int v = 0; v < R; ++v) {
        if (key > first + v / G) {  // past this row's causal frontier
          if (lane == 0) p_s[v * bs + r] = kNegInf;
          continue;
        }
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          if (D >= 32 || lane < D) s += q_s[v * D + lane + 32 * e] * kr[e];
        s = warp_sum(s);
        if (lane == 0) p_s[v * bs + r] = s * scale;
      }
    }
    __syncthreads();

    // online softmax: one warp per query vector.  Key 0 is visible to
    // every row, so m is finite from the first tile on and a row whose
    // keys in a later tile are all masked gets p = 0, corr = 1.
    for (int v = warp; v < R; v += kWarps) {
      float mx = kNegInf;
      for (int r = lane; r < rows; r += 32) mx = fmaxf(mx, p_s[v * bs + r]);
      mx = warp_max(mx);
      const float m_old = m_s[v];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int r = lane; r < rows; r += 32) {
        const float p = expf(p_s[v * bs + r] - m_new);
        p_s[v * bs + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[v] = corr;
        l_s[v] = l_s[v] * corr + sum;
        m_s[v] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ V: one thread per (query vector, element)
    for (int i = tid; i < R * D; i += kThreads) {
      const int v = i / D;
      const int d = i - v * D;
      float a = acc[i] * c_s[v];
      for (int r = 0; r < rows; ++r) a += p_s[v * bs + r] * v_s[r * D + d];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < R * D; i += kThreads) {
    const int v = i / D;
    const int r = v / G;
    o_tile[r * q_row_stride + (v - r * G) * D + i % D] =
        from_float<T>(acc[i] / fmaxf(l_s[v], 1e-30f));
  }
}

template <typename T, typename P>
cudaError_t commit(const void* k_new, const void* v_new, void* k_pool,
                   void* v_pool, void* k_scale, void* v_scale,
                   const void* k_amax, const void* v_amax,
                   const void* block_tables, const void* q_start,
                   const void* q_len, int B, int C, int KV, int D, int bs,
                   int nb, cudaStream_t stream) {
  if (std::is_same_v<P, int8_t> && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  if ((k_amax == nullptr) != (v_amax == nullptr) ||
      (k_amax != nullptr && !std::is_same_v<P, int8_t>))
    return cudaErrorInvalidValue;
  prefill_commit_kernel<T, P><<<dim3(C, B), kCommitThreads, 0, stream>>>(
      static_cast<const T*>(k_new), static_cast<const T*>(v_new),
      static_cast<P*>(k_pool), static_cast<P*>(v_pool),
      static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const float*>(k_amax), static_cast<const float*>(v_amax),
      static_cast<const int*>(block_tables), static_cast<const int*>(q_start),
      static_cast<const int*>(q_len), C, KV * D, bs, nb);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                   const void* k_amax, const void* v_amax,
                   const void* block_tables, const void* q_start,
                   const void* q_len, void* out, int B, int C, int KV, int G,
                   int D, int bs, int nb, int bc, int smem,
                   cudaStream_t stream) {
  if (bc < 1 || smem < 1) return cudaErrorInvalidValue;
  cudaError_t err = commit<T, P>(k_new, v_new, k_pool, v_pool, k_scale,
                                 v_scale, k_amax, v_amax, block_tables,
                                 q_start, q_len, B, C, KV, D, bs, nb, stream);
  if (err != cudaSuccess) return err;

  const dim3 grid(KV, B, (C + bc - 1) / bc);
  const T* qt = static_cast<const T*>(q);
  const P* kt = static_cast<const P*>(k_pool);
  const P* vt = static_cast<const P*>(v_pool);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_tables);
  const int* qs = static_cast<const int*>(q_start);
  const int* ql = static_cast<const int*>(q_len);
  T* ot = static_cast<T*>(out);
  switch (D) {
    case 16:
      prefill_attend_kernel<T, P, 16><<<grid, kThreads, smem, stream>>>(
          qt, kt, vt, ks, vs, bt, qs, ql, ot, C, KV, G, bs, nb, bc);
      break;
    case 32:
      prefill_attend_kernel<T, P, 32><<<grid, kThreads, smem, stream>>>(
          qt, kt, vt, ks, vs, bt, qs, ql, ot, C, KV, G, bs, nb, bc);
      break;
    case 64:
      prefill_attend_kernel<T, P, 64><<<grid, kThreads, smem, stream>>>(
          qt, kt, vt, ks, vs, bt, qs, ql, ot, C, KV, G, bs, nb, bc);
      break;
    case 128:
      prefill_attend_kernel<T, P, 128><<<grid, kThreads, smem, stream>>>(
          qt, kt, vt, ks, vs, bt, qs, ql, ot, C, KV, G, bs, nb, bc);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// The (q, pool) dtype pairs with an instantiation; dtype / pool_dtype: 0 =
// float32, 1 = bfloat16, 2 = int8.  Any other pair returns an
// invalid-value code.
#define FP_DISPATCH(CALL)                                            \
  if (dtype == 0 && pool_dtype == 0)                                 \
    return static_cast<int>(CALL(float, float));                     \
  if (dtype == 0 && pool_dtype == 1)                                 \
    return static_cast<int>(CALL(float, __nv_bfloat16));             \
  if (dtype == 0 && pool_dtype == 2)                                 \
    return static_cast<int>(CALL(float, int8_t));                    \
  if (dtype == 1 && pool_dtype == 1)                                 \
    return static_cast<int>(CALL(__nv_bfloat16, __nv_bfloat16));     \
  if (dtype == 1 && pool_dtype == 2)                                 \
    return static_cast<int>(CALL(__nv_bfloat16, int8_t));            \
  return static_cast<int>(cudaErrorInvalidValue)

// Launches the commit, then the attention, on ``stream``.  k_scale and
// v_scale are NULL unless the pools are int8; k_amax and v_amax (B, C) are
// NULL unless the caller gives each row's amax for int8 pools.  smem: the
// attention block's dynamic shared memory in bytes for this bc, G, D, bs,
// nb and pool dtype, as laid out above prefill_attend_kernel (the caller
// computes it:
// prefill_smem_bytes in kernel.py).  Returns the first cudaGetLastError()
// that is not 0 (0 when both launches were accepted); never synchronises.
extern "C" int flash_prefill_paged_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* k_amax,
    const void* v_amax, const void* block_tables,
    const void* q_start, const void* q_len, void* out, int B, int C, int KV,
    int G, int D, int bs, int nb, int bc, int smem, int dtype, int pool_dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP_LAUNCH(T, P)                                                    \
  launch<T, P>(q, k_new, v_new, k_pool, v_pool, k_scale, v_scale, k_amax,  \
               v_amax, block_tables, q_start, q_len, out, B, C, KV, G, D,  \
               bs, nb, bc, smem, s)
  FP_DISPATCH(FP_LAUNCH);
#undef FP_LAUNCH
}

// The commit alone (a decode step's row is a chunk of one): k/v_new (B, C,
// KV, D) into the pools, and scales for int8 pools (from k_amax/v_amax
// when they are not NULL), on ``stream``.
extern "C" int flash_commit_paged_launch(
    const void* k_new, const void* v_new, void* k_pool, void* v_pool,
    void* k_scale, void* v_scale, const void* k_amax, const void* v_amax,
    const void* block_tables,
    const void* q_start, const void* q_len, int B, int C, int KV, int D,
    int bs, int nb, int dtype, int pool_dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FP_COMMIT(T, P)                                                    \
  commit<T, P>(k_new, v_new, k_pool, v_pool, k_scale, v_scale, k_amax,     \
               v_amax, block_tables, q_start, q_len, B, C, KV, D, bs, nb, s)
  FP_DISPATCH(FP_COMMIT);
#undef FP_COMMIT
}

extern "C" const char* flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
