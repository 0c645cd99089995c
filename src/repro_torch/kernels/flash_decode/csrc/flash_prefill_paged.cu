// Chunked prefill over a paged KV cache for Hopper (sm_90a): commit a
// chunk of K/V rows per serving slot into that slot's pool blocks, then
// causal attention of every chunk row over its slot's cache, read through
// its block table.
//
// Replaces both passes of the TPU kernel
// src/repro/kernels/flash_decode/kernel.py :: flash_prefill_paged: the
// commit (pallas_call at :573, body _prefill_commit_kernel) and the
// attention (pallas_call at :620, body _prefill_attn_kernel), for f32 and
// bf16 pools without scales.
//
// Contract (that of the TPU kernel, with zeros for the rows it leaves
// undefined):
//   q             (B, C, KV, G, D)       f32 or bf16
//   k_new/v_new   (B, C, KV, D)          dtype of q
//   k_pool/v_pool (n_blocks, bs, KV, D)  dtype of q, written in place
//   block_tables  (B, nb) int32          logical block -> pool block
//   q_start/q_len (B,) int32             rows c < q_len[b] of slot b sit
//                                        at positions q_start[b] + c
//   out           (B, C, KV, G, D)       dtype of q
// Row c < q_len[b] is committed at pool block block_tables[b, pos / bs],
// row pos % bs, with pos = q_start[b] + c, and attends to its slot's keys
// at positions <= pos.  Rows c >= q_len[b] commit nothing and come out as
// zeros.  The two kernels run on one stream, commit first, so a row sees
// the rows its own chunk committed.
//
// What bounds it on an H100: the K and V rows already cached, q_start per
// slot, read once, and the chunk's rows read once and written once,
// KV * D * 2 * sizeof(T) bytes each, over 3.35 TB/s, or the
// 4 * G * D * KV flops per (query row, causal key) pair at the tensor
// cores' rate, whichever is larger.  This kernel does its arithmetic in
// fp32 on the CUDA cores (67 TFLOP/s), with a warp reduction per score,
// so at serving sizes it is bound by that arithmetic and its barriers.
//
// Design, simple first:
//   * commit: one thread block per (chunk row, slot), which copies the
//     row's K and V as 16-byte words to their pool row.  Unlike the TPU
//     commit (grid (B, nb), kernel.py:332) it never reads or rewrites the
//     rest of a block, so blocks no table names keep their bytes without
//     aliasing;
//   * attend: one thread block per (KV head, slot, tile of bc chunk rows):
//     the decode kernel (flash_decode_paged.cu) with bc * G query vectors
//     and a per-row causal frontier.  The block loads the tile's queries
//     (as fp32) and its table row into shared memory and walks only the
//     logical blocks j < ceil((q_start + last row + 1) / bs), the TPU
//     kernel's skip of tiles past the causal frontier (kernel.py:449);
//   * one warp per K row computes that key's scores for every query
//     vector of the tile; each V tile is staged once in shared memory as
//     fp32 and read by all query vectors;
//   * running max, sum and accumulator stay in fp32; the output is written
//     in q's dtype;
//   * head dims 16, 32, 64 and 128: below D = 32 a K row takes one element
//     a lane and the lanes at or past D load nothing (predicated lanes); the
//     commit's 16-byte words hold for any KV * D * sizeof(T) that 16
//     divides (32 bytes a row at D = 16 in bf16).
// Left for later: wgmma/TMA tiles, splitting long prefixes across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCommitThreads = 128;
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

// Copies row c of slot b of k_new/v_new, row_words 16-byte words each, to
// its pool row.  Grid (C, B).
__global__ void __launch_bounds__(kCommitThreads)
    prefill_commit_kernel(const uint4* __restrict__ k_new,
                          const uint4* __restrict__ v_new,
                          uint4* __restrict__ k_pool,
                          uint4* __restrict__ v_pool,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ q_start,
                          const int* __restrict__ q_len, int C,
                          int row_words, int bs, int nb) {
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  if (c >= q_len[b]) return;
  const int pos = q_start[b] + c;
  const int j = min(pos / bs, nb - 1);
  const size_t blk = block_tables[static_cast<size_t>(b) * nb + j];
  const size_t dst = (blk * bs + pos % bs) * row_words;
  const size_t src = (static_cast<size_t>(b) * C + c) * row_words;
  for (int i = threadIdx.x; i < row_words; i += kCommitThreads) {
    k_pool[dst + i] = k_new[src + i];
    v_pool[dst + i] = v_new[src + i];
  }
}

// Shared memory, in floats, for R = bc * G query vectors: q (R*D), acc
// (R*D), the V tile (bs*D), p (R*bs), m, l, corr (R each), then the
// block-table row (nb ints).  Grid (KV, B, ceil(C / bc)).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    prefill_attend_kernel(const T* __restrict__ q,
                          const T* __restrict__ k_pool,
                          const T* __restrict__ v_pool,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ q_start,
                          const int* __restrict__ q_len,
                          T* __restrict__ out, int C, int KV, int G, int bs,
                          int nb, int bc) {
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
  int* table = reinterpret_cast<int*>(c_s + r_max);

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
    // element offset of row 0, head h, of this pool block
    const size_t base =
        (static_cast<size_t>(table[j]) * bs * KV + h) * static_cast<size_t>(D);

    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D;
      v_s[i] = to_float(v_pool[base + r * kv_row_stride + (i - r * D)]);
    }

    // scores: one warp per K row, every query vector of the tile
    for (int r = warp; r < rows; r += kWarps) {
      const T* k_row = k_pool + base + r * kv_row_stride;
      float kr[kPerLane];
#pragma unroll
      for (int e = 0; e < kPerLane; ++e)
        kr[e] = (D >= 32 || lane < D) ? to_float(k_row[lane + 32 * e]) : 0.f;
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

template <typename T>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_pool, void* v_pool, const void* block_tables,
                   const void* q_start, const void* q_len, void* out, int B,
                   int C, int KV, int G, int D, int bs, int nb, int bc,
                   int smem, cudaStream_t stream) {
  const int row_bytes = KV * D * static_cast<int>(sizeof(T));
  if (row_bytes % 16 != 0 || bc < 1 || smem < 1) return cudaErrorInvalidValue;
  const int* bt = static_cast<const int*>(block_tables);
  const int* qs = static_cast<const int*>(q_start);
  const int* ql = static_cast<const int*>(q_len);
  prefill_commit_kernel<<<dim3(C, B), kCommitThreads, 0, stream>>>(
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      static_cast<uint4*>(k_pool), static_cast<uint4*>(v_pool), bt, qs, ql,
      C, row_bytes / 16, bs, nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const dim3 grid(KV, B, (C + bc - 1) / bc);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k_pool);
  const T* vt = static_cast<const T*>(v_pool);
  T* ot = static_cast<T*>(out);
  switch (D) {
    case 16:
      prefill_attend_kernel<T, 16><<<grid, kThreads, smem, stream>>>(
          qt, kt, vt, bt, qs, ql, ot, C, KV, G, bs, nb, bc);
      break;
    case 32:
      prefill_attend_kernel<T, 32><<<grid, kThreads, smem, stream>>>(
          qt, kt, vt, bt, qs, ql, ot, C, KV, G, bs, nb, bc);
      break;
    case 64:
      prefill_attend_kernel<T, 64><<<grid, kThreads, smem, stream>>>(
          qt, kt, vt, bt, qs, ql, ot, C, KV, G, bs, nb, bc);
      break;
    case 128:
      prefill_attend_kernel<T, 128><<<grid, kThreads, smem, stream>>>(
          qt, kt, vt, bt, qs, ql, ot, C, KV, G, bs, nb, bc);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launches the commit, then the attention, on ``stream``.  dtype: 0 =
// float32, 1 = bfloat16.  smem: the attention block's dynamic shared
// memory in bytes for this bc, G, D, bs and nb, as laid out above
// prefill_attend_kernel (the caller computes it: prefill_smem_bytes in
// kernel.py).  Returns the first cudaGetLastError() that is not 0 (0 when
// both launches were accepted); never synchronises.
extern "C" int flash_prefill_paged_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* block_tables, const void* q_start,
    const void* q_len, void* out, int B, int C, int KV, int G, int D, int bs,
    int nb, int bc, int smem, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, k_new, v_new, k_pool, v_pool,
                                          block_tables, q_start, q_len, out,
                                          B, C, KV, G, D, bs, nb, bc, smem,
                                          s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16>(
        q, k_new, v_new, k_pool, v_pool, block_tables, q_start, q_len, out,
        B, C, KV, G, D, bs, nb, bc, smem, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
