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
// cores' rate, whichever is larger: at the serve shapes (8 slots, chunks
// of 64, qwen3-1.7b heads) 1.07 GFLOP, 1.1 us at the bf16 rate, 16 us at
// the fp32 CUDA-core rate, against about 5 us of bytes.  A score taken
// as one warp's dot product finished by a shuffle chain, a few keys
// between block barriers, is latency, not arithmetic (about 250 times this
// bound on the card), so the scores are products of register tiles.
//
// Design:
//   * commit: one thread block per (chunk row, slot).  It converts the
//     row's K and V elements to P, or, for int8, reduces |x| over the row
//     to its amax first (one block reduction each for K and V) and then
//     writes the codes and the scale.  Unlike the TPU commit (grid (B, nb),
//     kernel.py:332) it never reads or rewrites the rest of a block, so
//     blocks no table names keep their bytes without aliasing.  It also
//     runs alone (flash_commit_paged_launch): a mesh rank commits the
//     other data ranks' decode rows with it.  A decode step's own rows are
//     committed by the decode kernel (flash_decode_paged.cu, kCommit) with
//     the same arithmetic, bit for bit;
//   * attend: one thread block per (KV head, slot, tile of `rows` chunk
//     rows): rows * G <= 64 query vectors (64 rows at G = 1, 32 at G = 2,
//     8 at G = 8).  It loads its table row into shared memory once and
//     walks key tiles of kt rows (whole pool blocks: 64 rows, 4 blocks, at
//     bs = 16) up to its causal frontier, the TPU kernel's skip of tiles
//     past it (kernel.py:449).  K and V tiles are staged by cp.async in
//     16-byte vectors, two stages, so tile j + 1 loads while tile j
//     computes.  Rows past the block's frontier (and their scales) are
//     never read: their cp.async zero-fills, and a key past a row's
//     position is masked to -inf before the softmax, never after a
//     multiply, so poisoned bytes there cannot reach the output;
//   * bf16 q over bf16 pools (the serve path) runs both products on the
//     tensor cores, as FlashAttention-2 does: each of 4 warps owns 16
//     query vectors; S = Q K^T by mma.sync m16n8k16 (bf16 -> fp32, exact
//     products) from ldmatrix'd fragments, the online softmax on the
//     accumulators with one 2-step quad reduction a row and tile, and
//     P (rounded to bf16) V by mma.sync with V's fragments from
//     ldmatrix.trans.  mma.sync came first because it is what a simple,
//     right kernel needs: synchronous, per warp, with a register layout
//     that feeds S straight into P V.  wgmma (64-row warpgroup products)
//     and TMA loads with mbarriers are this kernel's next step;
//   * every other pair (f32 q, or int8 pools) holds decode_close, 1e-5,
//     so it stays in fp32 on the CUDA cores as a register-tiled product:
//     16 x 16 threads, each owning a 4 x 4 micro-tile of (query vector,
//     key) scores and then 4 query vectors x D / 16 elements of the
//     output, read from shared memory as float4.  There is no shuffle
//     chain per score: one 4-step reduction a row and tile gives the
//     running max.  bf16 and int8 tiles are widened to fp32 in shared
//     memory once they land (int8 as code * the row's fp32 scale);
//   * running max, sum and accumulator stay in fp32; the output is written
//     in q's dtype; head dims 16, 32, 64 and 128.
// The wrapper computes the dynamic shared memory from one Python function
// (kernel.prefill_plan) and passes it; above 48 KB each instantiation
// raises its limit once per device.
//
// Launch variants: the attention kernels are templates over VECS, the query
// vectors a block takes, and KEYS, the key rows a tile stages.  The mma
// route runs VECS / 16 warps, the fp32 route 16 x VECS / 4 threads, each
// 4 query vectors x KEYS / 16 keys of a tile.  flash_prefill_paged.cu
// instantiates the default, 64 x 64, for every (q, pool) pair;
// flash_prefill_variants.cu the tuner's 64 x 32, 32 x 64 and 32 x 32 for
// the pairs its space reaches, f32 q over f32 pools and bf16 over bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kCommitThreads = 128;

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


// -- the attention: tiles of query vectors against tiles of keys ------------

// A block takes up to VECS query vectors (rows * G of them) and walks key
// tiles of up to KEYS rows, staged in shared memory in two stages.
// threads of the mma route: warps of 16 query vectors each
template <int VECS>
constexpr int kMmaThreads = VECS * 2;
// threads of the fp32 route: 16 x VECS / 4, a 4 x KEYS / 16 micro-tile each
template <int VECS>
constexpr int kSimtThreads = VECS * 4;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async of 16 (or 4) bytes; when !live the source is not read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows n_rows .. rows_here - 1 of a tile (at or past q_len) are zeros.
template <int kN, typename T>
__device__ __forceinline__ void zero_rows(T* o_tile, int n_rows,
                                          int rows_here, int GD,
                                          size_t q_stride) {
  for (int i = threadIdx.x; i < (rows_here - n_rows) * GD; i += kN) {
    const int r = n_rows + i / GD;
    o_tile[r * q_stride + i % GD] = from_float<T>(0.f);
  }
}

// K and V rows j * kt .. j * kt + kt - 1 of the slot, those below
// frontier, into rows 0 .. kt - 1 of a stage (rows of D * sizeof(P) + 16
// bytes), and for int8 their scales; every other row of the stage is
// zero-filled, its source never read.
template <typename P, int D, int kN, int KEYS>
__device__ __forceinline__ void stage_tile(
    unsigned char* kd, unsigned char* vd, float* skd, float* svd,
    const P* __restrict__ k_pool, const P* __restrict__ v_pool,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const int* table, int j, int kt, int frontier, int bs, size_t kv_row,
    size_t head) {
  constexpr int kRow = D * sizeof(P) + 16;
  constexpr int kChunks = D * sizeof(P) / 16;
  for (int i = threadIdx.x; i < KEYS * kChunks; i += kN) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    const int t = j * kt + r;
    const bool live = r < kt && t < frontier;
    size_t off = 0;
    if (live)
      off = (static_cast<size_t>(table[t / bs]) * bs + t % bs) * kv_row +
            head;
    cp_async16(kd + r * kRow + c * 16,
               reinterpret_cast<const unsigned char*>(k_pool + off) + c * 16,
               live);
    cp_async16(vd + r * kRow + c * 16,
               reinterpret_cast<const unsigned char*>(v_pool + off) + c * 16,
               live);
  }
  if constexpr (std::is_same_v<P, int8_t>) {
    for (int r = threadIdx.x; r < KEYS; r += kN) {
      const int t = j * kt + r;
      const bool live = r < kt && t < frontier;
      const size_t row =
          live ? static_cast<size_t>(table[t / bs]) * bs + t % bs : 0;
      cp_async4(skd + r, k_scale + row, live);
      cp_async4(svd + r, v_scale + row, live);
    }
  }
}

// -- the tensor-core route: bf16 q over bf16 pools --------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// c += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 -> fp32
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory (bytes; a staged row is 2 * D + 16 bytes, the 16 putting
// ldmatrix's 8 rows on distinct banks): q (VECS rows), then K and V of
// stage 0, K and V of stage 1 (KEYS rows each), then the table row (nb
// ints).  Grid (KV, B, ceil(C / rows)); thread (warp w, lane) holds the
// scores and outputs of query vectors 16 w + lane / 4 and that + 8.
template <int D, int VECS, int KEYS>
__global__ void __launch_bounds__(kMmaThreads<VECS>)
    prefill_attend_mma(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pool,
                       const __nv_bfloat16* __restrict__ v_pool,
                       const int* __restrict__ block_tables,
                       const int* __restrict__ q_start,
                       const int* __restrict__ q_len,
                       __nv_bfloat16* __restrict__ out, int C, int KV, int G,
                       int bs, int nb, int rows, int kt) {
  using bf16 = __nv_bfloat16;
  constexpr int kRow = 2 * D + 16;
  constexpr int kSteps = D / 16;  // k-steps of Q K^T
  constexpr int kOut = D / 8;     // n-tiles of the output
  constexpr int kN = kMmaThreads<VECS>;
  constexpr int kSt = KEYS / 8;   // n-tiles of S
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int GD = G * D;
  const int rows_here = min(rows, C - row0);
  const int n_rows = max(0, min(rows_here, min(q_len[b], C) - row0));
  const size_t q_stride = static_cast<size_t>(KV) * GD;
  const size_t tile = ((static_cast<size_t>(b) * C + row0) * KV + h) * GD;
  bf16* o_tile = out + tile;
  zero_rows<kN>(o_tile, n_rows, rows_here, GD, q_stride);
  if (n_rows == 0) return;  // uniform across the block

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* qs = smem;
  unsigned char* stages = qs + VECS * kRow;
  int* table = reinterpret_cast<int*>(stages + 4 * KEYS * kRow);

  // the tile's first row sits at `first`; keys below `frontier` are read
  const int first = q_start[b] + row0;
  const int frontier = min(first + n_rows, nb * bs);
  const int n_tiles = (frontier + kt - 1) / kt;
  for (int j = threadIdx.x; j < (frontier + bs - 1) / bs; j += kN)
    table[j] = block_tables[static_cast<size_t>(b) * nb + j];
  __syncthreads();

  const int nv = n_rows * G;  // live query vectors
  for (int i = threadIdx.x; i < VECS * (D / 8); i += kN) {
    const int v = i / (D / 8);
    const int c = i - v * (D / 8);
    const int r = v / G;
    const bool live = v < nv;
    const bf16* src = live ? q + tile + r * q_stride + (v - r * G) * D + c * 8
                           : q;
    cp_async16(qs + v * kRow + c * 16, src, live);
  }
  const size_t kv_row = static_cast<size_t>(KV) * D;
  const size_t head = static_cast<size_t>(h) * D;
  stage_tile<bf16, D, kN, KEYS>(stages, stages + KEYS * kRow, nullptr,
                                nullptr, k_pool, v_pool, nullptr, nullptr,
                                table, 0, kt, frontier, bs, kv_row, head);
  cp_async_commit();

  const int v_lo = warp * 16 + (lane >> 2);
  const int v_hi = v_lo + 8;
  const int pos_lo = first + v_lo / G;
  const int pos_hi = first + v_hi / G;
  const int mtx = lane >> 3;  // the 8 x 8 matrix this lane addresses
  const float scale = rsqrtf(static_cast<float>(D)) * 1.4426950408889634f;
  float o[kOut][4];
#pragma unroll
  for (int t = 0; t < kOut; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  uint32_t qf[kSteps][4];

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      unsigned char* next = stages + ((j + 1) & 1) * 2 * KEYS * kRow;
      stage_tile<bf16, D, kN, KEYS>(
          next, next + KEYS * kRow, nullptr, nullptr, k_pool, v_pool,
          nullptr, nullptr, table, j + 1, kt, frontier, bs, kv_row, head);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        ldmatrix_x4(qf[s], smem_addr(qs + (warp * 16 + (lane & 15)) * kRow +
                                     (s * 16 + (lane >> 4) * 8) * 2));
    }
    const unsigned char* kd = stages + (j & 1) * 2 * KEYS * kRow;
    const unsigned char* vd = kd + KEYS * kRow;

    // S = Q K^T, 16 query vectors x KEYS keys a warp, in the log2 domain
    float s[kSt][4];
#pragma unroll
    for (int t = 0; t < kSt; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int np = 0; np < kSt / 2; ++np) {
        uint32_t bk[4];
        ldmatrix_x4(bk, smem_addr(kd + (np * 16 + (mtx >> 1) * 8 +
                                        (lane & 7)) * kRow +
                                  (ks * 16 + (mtx & 1) * 8) * 2));
        mma_bf16(s[2 * np], qf[ks], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[ks], bk[2], bk[3]);
      }
    }
    // keys past a row's position, and the tile's padding past kt, are
    // masked; only a tile that reaches past the first row's position or is
    // padded has any
    const bool masked = (j + 1) * kt - 1 > first || kt < KEYS;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int t = 0; t < kSt; ++t) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[t][c] * scale;
        if (masked) {
          const int kl = t * 8 + 2 * (lane & 3) + (c & 1);
          if (kl >= kt || j * kt + kl > (c < 2 ? pos_lo : pos_hi))
            x = -INFINITY;
        }
        s[t][c] = x;
        if (c < 2)
          mx_lo = fmaxf(mx_lo, x);
        else
          mx_hi = fmaxf(mx_hi, x);
      }
    }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, d));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, d));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo);
    const float mn_hi = fmaxf(m_hi, mx_hi);
    const float base_lo = mn_lo == -INFINITY ? 0.f : mn_lo;
    const float base_hi = mn_hi == -INFINITY ? 0.f : mn_hi;
    const float c_lo = exp2f(m_lo - base_lo);
    const float c_hi = exp2f(m_hi - base_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    l_lo *= c_lo;
    l_hi *= c_hi;
#pragma unroll
    for (int t = 0; t < kOut; ++t) {
      o[t][0] *= c_lo;
      o[t][1] *= c_lo;
      o[t][2] *= c_hi;
      o[t][3] *= c_hi;
    }
#pragma unroll
    for (int t = 0; t < kSt; ++t) {
      s[t][0] = exp2f(s[t][0] - base_lo);
      s[t][1] = exp2f(s[t][1] - base_lo);
      s[t][2] = exp2f(s[t][2] - base_hi);
      s[t][3] = exp2f(s[t][3] - base_hi);
      l_lo += s[t][0] + s[t][1];
      l_hi += s[t][2] + s[t][3];
    }

    // O += P V: S's accumulators are P's A fragments, V's from
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kSt / 2; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, smem_addr(vd + (kk * 16 + (mtx & 1) * 8 +
                                              (lane & 7)) * kRow +
                                        (dp * 16 + (mtx >> 1) * 8) * 2));
        mma_bf16(o[2 * dp], a, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage is refilled two tiles on
  }

#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, d);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, d);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int v = half ? v_hi : v_lo;
    if (v >= nv) continue;
    const float inv = 1.f / fmaxf(half ? l_hi : l_lo, 1e-30f);
    const int r = v / G;
    bf16* dst = o_tile + r * q_stride + (v - r * G) * D + 2 * (lane & 3);
#pragma unroll
    for (int t = 0; t < kOut; ++t)
      *reinterpret_cast<__nv_bfloat162*>(dst + t * 8) = __floats2bfloat162_rn(
          o[t][2 * half] * inv, o[t][2 * half + 1] * inv);
  }
}

// -- the fp32 route: f32 q, or int8 pools -----------------------------------

// Four staged pool elements at raw widened to fp32: code * scale for int8,
// the element itself for bf16.
template <typename P>
__device__ __forceinline__ float4 widen4(const unsigned char* raw,
                                         float scale) {
  if constexpr (std::is_same_v<P, int8_t>) {
    const char4 c = *reinterpret_cast<const char4*>(raw);
    return make_float4(static_cast<float>(c.x) * scale,
                       static_cast<float>(c.y) * scale,
                       static_cast<float>(c.z) * scale,
                       static_cast<float>(c.w) * scale);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(raw);
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  }
}

// Shared memory (bytes): q in fp32 (VECS rows of D + 4 floats), p
// (VECS rows of KEYS + 4 floats), for bf16 and int8 pools the widened K
// and V tiles (KEYS rows of D + 4 floats each), the raw stages K0, V0,
// K1, V1 (KEYS rows of D * sizeof(P) + 16 bytes each; f32 pools are
// read there directly), for int8 the stages' scales (4 x KEYS floats),
// then the table row (nb ints).  Grid (KV, B, ceil(C / rows)); thread
// (ty, tx) of 16 x 16 owns query vectors 4 ty .. 4 ty + 3, keys tx + 16 j
// (j < 4) of a tile, and output elements (tx + 16 c) * kVec + e.
template <typename T, typename P, int D, int VECS, int KEYS>
__global__ void __launch_bounds__(kSimtThreads<VECS>, 1)
    prefill_attend_simt(const T* __restrict__ q, const P* __restrict__ k_pool,
                        const P* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ q_start,
                        const int* __restrict__ q_len, T* __restrict__ out,
                        int C, int KV, int G, int bs, int nb, int rows,
                        int kt) {
  constexpr bool kQuant = std::is_same_v<P, int8_t>;
  constexpr bool kWiden = !std::is_same_v<P, float>;
  constexpr int kF = D + 4;        // floats a staged fp32 row
  constexpr int kP = KEYS + 4;    // floats a row of p
  constexpr int kRow = D * sizeof(P) + 16;
  constexpr int kOut = D / 16;     // output elements a thread, each vector
  constexpr int kVec = kOut < 4 ? kOut : 4;
  constexpr int kN = kSimtThreads<VECS>;
  constexpr int kJ = KEYS / 16;    // keys a thread, each tile
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * rows;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int GD = G * D;
  const int rows_here = min(rows, C - row0);
  const int n_rows = max(0, min(rows_here, min(q_len[b], C) - row0));
  const size_t q_stride = static_cast<size_t>(KV) * GD;
  const size_t tile = ((static_cast<size_t>(b) * C + row0) * KV + h) * GD;
  T* o_tile = out + tile;
  zero_rows<kN>(o_tile, n_rows, rows_here, GD, q_stride);
  if (n_rows == 0) return;  // uniform across the block

  extern __shared__ __align__(16) unsigned char smem[];
  float* qf = reinterpret_cast<float*>(smem);
  float* ps = qf + VECS * kF;
  float* kf = ps + VECS * kP;
  float* vf = kf + (kWiden ? KEYS * kF : 0);
  unsigned char* stages =
      reinterpret_cast<unsigned char*>(vf + (kWiden ? KEYS * kF : 0));
  float* sc = reinterpret_cast<float*>(stages + 4 * KEYS * kRow);
  int* table = reinterpret_cast<int*>(sc + (kQuant ? 4 * KEYS : 0));

  const int first = q_start[b] + row0;
  const int frontier = min(first + n_rows, nb * bs);
  const int n_tiles = (frontier + kt - 1) / kt;
  for (int j = threadIdx.x; j < (frontier + bs - 1) / bs; j += kN)
    table[j] = block_tables[static_cast<size_t>(b) * nb + j];
  const int nv = n_rows * G;
  for (int i = threadIdx.x; i < VECS * D; i += kN) {
    const int v = i / D;
    const int d = i - v * D;
    const int r = v / G;
    qf[v * kF + d] =
        v < nv ? to_float(q[tile + r * q_stride + (v - r * G) * D + d]) : 0.f;
  }
  __syncthreads();

  const size_t kv_row = static_cast<size_t>(KV) * D;
  const size_t head = static_cast<size_t>(h) * D;
  stage_tile<P, D, kN, KEYS>(stages, stages + KEYS * kRow, sc,
                                 sc + KEYS, k_pool, v_pool, k_scale,
                                 v_scale, table, 0, kt, frontier, bs, kv_row,
                                 head);
  cp_async_commit();

  int pos[4];
  float m[4], l[4], acc[4][kOut];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pos[i] = first + (ty * 4 + i) / G;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kOut; ++e) acc[i][e] = 0.f;
  }
  const float scale = rsqrtf(static_cast<float>(D));

  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) {
      const int st = (j + 1) & 1;
      unsigned char* next = stages + st * 2 * KEYS * kRow;
      stage_tile<P, D, kN, KEYS>(
          next, next + KEYS * kRow, sc + st * 2 * KEYS,
          sc + st * 2 * KEYS + KEYS, k_pool, v_pool, k_scale, v_scale,
          table, j + 1, kt, frontier, bs, kv_row, head);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned char* kr = stages + (j & 1) * 2 * KEYS * kRow;
    const unsigned char* vr = kr + KEYS * kRow;
    const float* kt_f = reinterpret_cast<const float*>(kr);
    const float* vt_f = reinterpret_cast<const float*>(vr);
    if constexpr (kWiden) {  // the tile widened to fp32 once it has landed
      const float* sk = sc + (j & 1) * 2 * KEYS;
      const float* sv = sk + KEYS;
      for (int i = threadIdx.x; i < KEYS * (D / 4); i += kN) {
        const int r = i / (D / 4);
        const int c = i - r * (D / 4);
        const int at = r * kRow + c * 4 * static_cast<int>(sizeof(P));
        *reinterpret_cast<float4*>(kf + r * kF + c * 4) =
            widen4<P>(kr + at, kQuant ? sk[r] : 1.f);
        *reinterpret_cast<float4*>(vf + r * kF + c * 4) =
            widen4<P>(vr + at, kQuant ? sv[r] : 1.f);
      }
      __syncthreads();
      kt_f = kf;
      vt_f = vf;
    }

    // S: this thread's 4 x kJ scores
    float s[4][kJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) s[i][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], k4[kJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qf + (ty * 4 + i) * kF + d);
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
        k4[jj] =
            *reinterpret_cast<const float4*>(kt_f + (tx + 16 * jj) * kF + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          float x = s[i][jj];
          x = fmaf(a[i].x, k4[jj].x, x);
          x = fmaf(a[i].y, k4[jj].y, x);
          x = fmaf(a[i].z, k4[jj].z, x);
          x = fmaf(a[i].w, k4[jj].w, x);
          s[i][jj] = x;
        }
    }

    // online softmax: one 4-step reduction a row for its running max; the
    // sum stays per thread until the end
    const bool masked = (j + 1) * kt - 1 > first || kt < KEYS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        float x = s[i][jj] * scale;
        const int kl = tx + 16 * jj;
        if (masked && (kl >= kt || j * kt + kl > pos[i])) x = -INFINITY;
        s[i][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int d = 1; d < 16; d <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      const float mn = fmaxf(m[i], mx);
      const float base = mn == -INFINITY ? 0.f : mn;
      const float corr = expf(m[i] - base);
      m[i] = mn;
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < kOut; ++e) acc[i][e] *= corr;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const float p = expf(s[i][jj] - base);
        l[i] += p;
        ps[(ty * 4 + i) * kP + tx + 16 * jj] = p;
      }
    }
    __syncthreads();

    // O += P V
#pragma unroll 2
    for (int n = 0; n < KEYS; n += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * kP + n);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const float* vrow = vt_f + (n + nn) * kF;
        float vv[kOut];
#pragma unroll
        for (int c = 0; c < kOut / kVec; ++c) {
          const float* src = vrow + (tx + 16 * c) * kVec;
          if constexpr (kVec == 4) {
            const float4 x = *reinterpret_cast<const float4*>(src);
            vv[4 * c] = x.x;
            vv[4 * c + 1] = x.y;
            vv[4 * c + 2] = x.z;
            vv[4 * c + 3] = x.w;
          } else {
#pragma unroll
            for (int e = 0; e < kVec; ++e) vv[c * kVec + e] = src[e];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = nn == 0   ? p4[i].x
                          : nn == 1 ? p4[i].y
                          : nn == 2 ? p4[i].z
                                    : p4[i].w;
#pragma unroll
          for (int e = 0; e < kOut; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
    __syncthreads();  // p, the widened tiles and the stage are reused
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = l[i];
#pragma unroll
    for (int d = 1; d < 16; d <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, d);
    const int v = ty * 4 + i;
    if (v >= nv) continue;
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int r = v / G;
    T* dst = o_tile + r * q_stride + (v - r * G) * D;
#pragma unroll
    for (int c = 0; c < kOut / kVec; ++c)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        dst[(tx + 16 * c) * kVec + e] =
            from_float<T>(acc[i][c * kVec + e] * inv);
  }
}

// The attention's launch for one (T, P, D): the tensor-core route for
// bf16 q over bf16 pools, the fp32 route for every other pair.  Above
// 48 KB of dynamic shared memory a kernel needs its limit raised, once
// for each instantiation and device.
template <typename T, typename P, int D, int VECS, int KEYS>
cudaError_t attend(const dim3 grid, size_t smem, cudaStream_t stream,
                   int device, const void* q, const void* k_pool,
                   const void* v_pool, const float* k_scale,
                   const float* v_scale, const int* block_tables,
                   const int* q_start, const int* q_len, void* out, int C,
                   int KV, int G, int bs, int nb, int rows, int kt) {
  constexpr bool kMma = std::is_same_v<T, __nv_bfloat16> &&
                        std::is_same_v<P, __nv_bfloat16>;
  const void* fn;
  if constexpr (kMma)
    fn = reinterpret_cast<const void*>(prefill_attend_mma<D, VECS, KEYS>);
  else
    fn = reinterpret_cast<const void*>(
        prefill_attend_simt<T, P, D, VECS, KEYS>);
  static bool raised[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!raised[device]) {
    int optin = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  if constexpr (kMma)
    prefill_attend_mma<D, VECS, KEYS>
        <<<grid, kMmaThreads<VECS>, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool), block_tables, q_start,
        q_len, static_cast<__nv_bfloat16*>(out), C, KV, G, bs, nb, rows, kt);
  else
    prefill_attend_simt<T, P, D, VECS, KEYS>
        <<<grid, kSimtThreads<VECS>, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const P*>(k_pool),
        static_cast<const P*>(v_pool), k_scale, v_scale, block_tables,
        q_start, q_len, static_cast<T*>(out), C, KV, G, bs, nb, rows, kt);
  return cudaGetLastError();
}

template <typename T, typename P, int VECS, int KEYS>
cudaError_t launch(const void* q, const void* k_new, const void* v_new,
                   void* k_pool, void* v_pool, void* k_scale, void* v_scale,
                   const void* k_amax, const void* v_amax,
                   const void* block_tables, const void* q_start,
                   const void* q_len, void* out, int B, int C, int KV, int G,
                   int D, int bs, int nb, int rows, int kt, int smem,
                   int device, cudaStream_t stream) {
  if (rows < 1 || rows * G > VECS || kt < 1 || kt > KEYS || smem < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = commit<T, P>(k_new, v_new, k_pool, v_pool, k_scale,
                                 v_scale, k_amax, v_amax, block_tables,
                                 q_start, q_len, B, C, KV, D, bs, nb, stream);
  if (err != cudaSuccess) return err;

  const dim3 grid(KV, B, (C + rows - 1) / rows);
#define FP_ATTEND(DD)                                                       \
  return attend<T, P, DD, VECS, KEYS>(                                      \
      grid, smem, stream, device, q, k_pool, v_pool,                        \
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale), \
      static_cast<const int*>(block_tables),                                \
      static_cast<const int*>(q_start), static_cast<const int*>(q_len), out, \
      C, KV, G, bs, nb, rows, kt)
  switch (D) {
    case 16:
      FP_ATTEND(16);
    case 32:
      FP_ATTEND(32);
    case 64:
      FP_ATTEND(64);
    case 128:
      FP_ATTEND(128);
    default:
      return cudaErrorInvalidValue;
  }
#undef FP_ATTEND
}

}  // namespace

extern "C" const char* flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
