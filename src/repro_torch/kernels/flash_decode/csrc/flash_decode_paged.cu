// Flash-decode for Hopper (sm_90a): attention of one query token per
// serving slot over that slot's KV cache, read through its block table
// (paged) or in place from a contiguous (B, S, KV, D) cache.
//
// Replaces three TPU kernels of src/repro/kernels/flash_decode/kernel.py:
//   * flash_decode_paged (body _decode_kernel_paged, pallas_call at :256),
//     for pools in q's dtype, bf16 pools under an f32 q (widened,
//     :140-142) and int8 pools with per-row fp32 scales (the quantized
//     branch, :120-139), with its head_shard=(i, n) slice (:207-218): the
//     grid covers KV / n heads and reads the full pools from head
//     i * KV / n on, at the pools' own row stride, so the head slice is
//     never copied;
//   * flash_decode_paged_sharded (:264), whose per-device kernel is the
//     same body on each rank's local pools from head 0;
//   * flash_decode (body _decode_kernel, pallas_call at :89), the
//     contiguous cache.  The TPU wrapper makes a head-major copy of K and
//     V first (kernel.py:87-88); this kernel reads (B, S, KV, D) in place
//     with a row stride of KV * D.
// One body serves all three: the template flag kPaged picks table or
// stride addressing of a row, and nothing else differs.  A paged launch
// may also commit each slot's new K/V row before it attends (kCommit): the
// commit pass of the TPU kernel flash_prefill_paged (pallas_call at :573,
// _prefill_commit_kernel and _prefill_commit_kernel_q) for a decode step's
// one row a slot, which would otherwise be a launch of its own.
//
// Paged contract (that of the TPU kernel flash_decode_paged):
//   q            (B, KV, G, D)            T: f32 or bf16; KV is the
//                                         launch's (local) head count
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
// row is dequantized in fp32 with its scale, as the TPU kernel widens its
// tile in VMEM: q . (codes * s) is taken as (q . codes) * s and p * (codes
// * s) as (p * s) * codes, the same products up to fp32 rounding (the
// plain version's order, within decode_close); a bf16 pool element is
// widened to fp32.
//
// Contiguous contract (that of the TPU kernel flash_decode):
//   q            (B, KV, G, D)            f32 or bf16
//   k/v          (B, S, KV, D)            same dtype as q
//   valid_len    (B,) int32               live rows of each slot; a slot
//                                         with valid_len <= 0 gives zeros,
//                                         as the TPU kernel's clamped l does
//   out          (B, KV, G, D)            dtype of q
// Row t of slot b lives at k[b, t]; no row at or past valid_len[b] is read
// (the TPU kernel's predicated block skip).
//
// What bounds it on an H100: the bytes of the live K and V rows,
// sum_b valid_len[b] * (KV * D * 2 * sizeof(P) + 8 bytes of scales when P
// is int8), over 3.35 TB/s.  The arithmetic, 4 * G * D flops per live row
// and head, is far below what the card computes in that time, so the
// product stays in fp32 on the CUDA cores, p included: tensor cores would
// gain nothing at G <= 8 query heads a K row, and fp32 keeps every (q,
// pool) pair within decode_close of its plain version.  At the serve
// shapes (8 slots of a few hundred rows) those bytes take a few
// microseconds, so the time goes to latency: one block walking a slot's
// rows in series would leave most of the card idle (one block a KV head
// and slot is 64 blocks at qwen3's serve shapes, on 132 SMs), so the rows
// are spread over blocks and warps with many loads in flight.
//
// Design:
//   * the sequence is split across blocks: grid (KV * G / GC, B, splits),
//     where GC in {1, 2, 4} query heads of a KV head share a block (G / GC
//     blocks read the same K/V rows when G > 4).  Split z takes the rows
//     [z * L, (z + 1) * L) below valid_len[b]; L (split_rows, a multiple of
//     bs and of the contiguous tile) and the number of splits come from the
//     shapes alone (nb * bs or S), so the host never reads valid_len.  A
//     split with no live rows exits at once (split 0 of an empty
//     contiguous slot writes its zeros);
//   * inside a split every warp walks its own rows, 4 row steps of loads
//     in flight at a time: a row is read by D * sizeof(P) / 16 lanes, each
//     loading 16 bytes of K and of V (int8 under 4 query heads a block: 8
//     bytes), so a warp reads 32 / that many rows at once (twice as many
//     int8 rows as bf16 ones), and the lanes of a row reduce their partial
//     dot products in log2 of that many shuffles.  Each
//     group of lanes keeps its own running max, sum and accumulator
//     (fp32) for the GC query heads, rescaled once per step batch; no block
//     barrier is taken until the split's rows are done;
//   * then the lane groups of a warp are merged by shuffles and the warps
//     through shared memory, in a fixed order;
//   * a slot whose live rows fit one split writes its output there.
//     Otherwise each split writes its (m, l, acc) partial to scratch, and
//     the last split of a (slot, head) to finish, found by a per-(slot,
//     head) counter after __threadfence(), merges the partials in split
//     order, writes the output and resets the counter to 0.  One launch a
//     call; the wrapper keeps the scratch per device, stream and size class
//     and allocates none per call;
//   * L, the split boundaries and every merge order depend on neither KV,
//     head0, B nor the grid, so a head slice (i, n) of the heads is bit for
//     bit the unsharded launch's slice.
//   * kCommit: each slot's new row goes at position valid_len[b] - 1, in
//     the last live split, which alone reads that row (splits cover rows
//     below the frontier only), so no block waits on another.  Each block
//     of that split loads its KV head's D elements of the row (and, for
//     int8 without a given amax, the row's amax over all heads) while it
//     loads its table, writes the head's slice (converted, or quantized
//     with the row's fresh scale, which it also writes) through the table
//     as the commit kernel places it, and passes a __syncthreads before its
//     walk reads the row back at L2 (ld.global.cg: the pools' __restrict__
//     would otherwise allow the read-only path).  Blocks of one KV head
//     (G > 4) write the same bytes.  The quantization is the commit
//     kernel's, so pools, scales and output are bit for bit those of the
//     commit kernel followed by the decode.
// Left for later: TMA loads, and removing the launch latency by capturing
// the whole decode step in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// row steps of a warp whose loads are issued together
constexpr int kUnroll = 4;
// table entries of one split (split_rows / bs; the wrapper keeps it there)
constexpr int kMaxTable = 256;
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
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

// The vector of N pool elements one lane loads from a row (16 or 8
// bytes), widened to fp32 by widen().
template <typename P, int N>
struct Lane {
  using raw = std::conditional_t<N * sizeof(P) == 16, uint4, uint2>;
  static_assert(N * sizeof(P) == 16 || N * sizeof(P) == 8);
};

// Elements of a row one lane loads: 16 bytes of f32 or bf16; 16 codes of
// int8 for up to 2 query heads a block, 8 (8 bytes) for 4, which would
// otherwise hold 64 fp32 accumulators a lane.
template <typename P, int GC>
__host__ __device__ constexpr int lane_elems() {
  return std::is_same_v<P, int8_t> ? (GC <= 2 ? 16 : 8) : 16 / sizeof(P);
}

// A lane's raw vector widened to fp32: the elements, or for int8 the
// codes (the caller applies the row's scale once a row).  A code c is
// made exactly without a conversion instruction: the bits 0x4B0000xx with
// xx = c + 128 are the float 2^23 + c + 128.
template <typename P, int N>
__device__ __forceinline__ void widen(const typename Lane<P, N>::raw& x,
                                      float* f) {
  constexpr int kWords = sizeof(x) / 4;
  uint32_t w[kWords];
  memcpy(w, &x, sizeof(x));
  if constexpr (std::is_same_v<P, float>) {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = __uint_as_float(w[i]);
  } else if constexpr (std::is_same_v<P, __nv_bfloat16>) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) {  // element 2i in the low half
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)  // code i in byte i
      f[i] = __uint_as_float(__byte_perm(w[i / 4] ^ 0x80808080u,
                                         0x4B000000u, 0x7540u | (i % 4))) -
             8388736.f;
  }
}

// The fused commit's arguments (kCommit): each slot's new K and V row,
// (B, KV, D) in T over the launch's KV heads, its amax over all the pool's
// heads (B,) or NULL (int8 only), and the pools and scales it is written
// to: the addresses the kernel reads them from, passed again as writable.
template <typename T, typename P>
struct Commit {
  const T* k_new = nullptr;
  const T* v_new = nullptr;
  const float* k_amax = nullptr;
  const float* v_amax = nullptr;
  P* k_pool = nullptr;
  P* v_pool = nullptr;
  float* k_scale = nullptr;
  float* v_scale = nullptr;
};

// A load at L2 (ld.global.cg), ordered after the block's own stores to
// the pools by the __syncthreads between them: the fused commit's reads,
// which must not take the read-only path (ld.global.nc) that the pools'
// __restrict__ would otherwise allow.
template <typename R>
__device__ __forceinline__ R load_cg(const void* p);
template <>
__device__ __forceinline__ uint4 load_cg<uint4>(const void* p) {
  uint4 r;
  asm volatile("ld.global.cg.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p)
               : "memory");
  return r;
}
template <>
__device__ __forceinline__ uint2 load_cg<uint2>(const void* p) {
  uint2 r;
  asm volatile("ld.global.cg.v2.u32 {%0, %1}, [%2];"
               : "=r"(r.x), "=r"(r.y)
               : "l"(p)
               : "memory");
  return r;
}
template <>
__device__ __forceinline__ float load_cg<float>(const void* p) {
  float r;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(r) : "l"(p) : "memory");
  return r;
}

// One element of a new row in the pools' dtype: converted, or for int8
// the code of x under the row's scale s (round half to even, clipped).
template <typename P>
__device__ __forceinline__ P store_elem(float x, float s) {
  if constexpr (std::is_same_v<P, int8_t>)
    return static_cast<int8_t>(fminf(fmaxf(rintf(x / s), -127.f), 127.f));
  else
    return from_float<P>(x);
}

// Scratch of one (slot, head chunk, split): acc (GC * D), then m and l (GC
// each), in fp32.  Counters: one int a (slot, head chunk), 0 between
// launches.
template <typename T, typename P, int D, int GC, bool kPaged, bool kCommit>
__global__ void __launch_bounds__(kThreads, 2)
    flash_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                        const P* __restrict__ v_pool,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ valid_len,
                        T* __restrict__ out, float* __restrict__ partial,
                        int* __restrict__ counters, int KV, int G, int bs,
                        int nb, int S, int pool_kv, int head0,
                        int split_rows, const Commit<T, P> cm) {
  constexpr bool kQuant = std::is_same_v<P, int8_t>;
  constexpr int kElems = lane_elems<P, GC>();  // elements a lane loads
  using L = Lane<P, kElems>;
  constexpr int kLanes = D / kElems;     // lanes a row: 2 .. 32
  constexpr int kRows = 32 / kLanes;     // rows a warp step
  constexpr int kStep = kWarps * kRows;  // rows a block step
  constexpr int kPart = GC * D + 2 * GC;

  const int chunks = G / GC;
  const int hx = blockIdx.x;
  const int h = hx / chunks;
  const int g0 = (hx - h * chunks) * GC;
  const int b = blockIdx.y;
  const int z = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int group = lane / kLanes;
  const int sub = lane - group * kLanes;

  const int len = valid_len[b];
  const int valid = min(len, kPaged ? nb * bs : S);
  const int n_live = valid > 0 ? (valid + split_rows - 1) / split_rows : 0;
  const size_t vec = (static_cast<size_t>(b) * KV + h) * G + g0;
  T* o = out + vec * D;
  if (z >= n_live) {
    if (z == 0)  // an empty contiguous slot: zeros
      for (int i = threadIdx.x; i < GC * D; i += kThreads)
        o[i] = from_float<T>(0.f);
    return;  // uniform across the block
  }
  const int r0 = z * split_rows;
  const int r1 = min(r0 + split_rows, valid);

  __shared__ int table[kMaxTable];
  __shared__ float w_acc[kWarps][GC * D];
  __shared__ float w_ml[kWarps][2 * GC];
  __shared__ int last;

  const float scale = rsqrtf(static_cast<float>(D));
  float qr[GC][kElems];
  const T* qh = q + vec * D + sub * kElems;
#pragma unroll
  for (int g = 0; g < GC; ++g)
#pragma unroll
    for (int e = 0; e < kElems; ++e) qr[g][e] = to_float(qh[g * D + e]);

  // kCommit: the split that holds row len - 1 (the last live one) writes
  // the slot's new row there first, this block's head of it: its elements
  // and amax are loaded here, beside the table
  const bool writer = kCommit && z == n_live - 1;  // uniform
  float kx = 0.f, vx = 0.f, kmax = 0.f, vmax = 0.f;
  if (writer) {
    const size_t nrow = static_cast<size_t>(b) * KV * D;
    if (threadIdx.x < D) {
      kx = to_float(cm.k_new[nrow + h * D + threadIdx.x]);
      vx = to_float(cm.v_new[nrow + h * D + threadIdx.x]);
    }
    if constexpr (kQuant) {
      if (cm.k_amax != nullptr) {  // uniform
        kmax = cm.k_amax[b];
        vmax = cm.v_amax[b];
      } else {  // the row over all heads: the launch holds them all
        for (int i = threadIdx.x; i < KV * D; i += kThreads) {
          kmax = fmaxf(kmax, fabsf(to_float(cm.k_new[nrow + i])));
          vmax = fmaxf(vmax, fabsf(to_float(cm.v_new[nrow + i])));
        }
      }
    }
  }

  const int j0 = kPaged ? r0 / bs : 0;
  if (kPaged) {
    const int j1 = (r1 + bs - 1) / bs;
    for (int j = j0 + threadIdx.x; j < j1; j += kThreads)
      table[j - j0] = block_tables[static_cast<size_t>(b) * nb + j];
    __syncthreads();
  }

  // a row of the pools (or of the contiguous cache) holds pool_kv heads;
  // this block reads head head0 + h of each, this lane its kElems elements
  const size_t row_stride = static_cast<size_t>(pool_kv) * D;
  const size_t head_off = static_cast<size_t>(head0 + h) * D + sub * kElems;

  if (writer) {
    // row len - 1 at its table block, as the commit kernel places it (the
    // last table entry for a row past the table); the table entry is in
    // this split's part of the table
    const int pos = len - 1;
    const size_t dst =
        static_cast<size_t>(table[min(pos / bs, nb - 1) - j0]) * bs + pos % bs;
    float ks = 1.f, vs = 1.f;
    if constexpr (kQuant) {
      if (cm.k_amax == nullptr) {  // uniform: the block's max
#pragma unroll
        for (int o2 = 16; o2 > 0; o2 >>= 1) {
          kmax = fmaxf(kmax, __shfl_xor_sync(0xffffffffu, kmax, o2));
          vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, o2));
        }
        if (lane == 0) {
          w_ml[warp][0] = kmax;
          w_ml[warp][1] = vmax;
        }
        __syncthreads();  // w_ml is next written after the row walk
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          kmax = fmaxf(kmax, w_ml[w][0]);
          vmax = fmaxf(vmax, w_ml[w][1]);
        }
      }
      // XLA's amax / 127: the product with 127's fp32 reciprocal
      ks = fmaxf(kmax * (1.f / 127.f), 1e-8f);
      vs = fmaxf(vmax * (1.f / 127.f), 1e-8f);
      if (threadIdx.x == 0) {
        cm.k_scale[dst] = ks;
        cm.v_scale[dst] = vs;
      }
    }
    if (threadIdx.x < D) {
      const size_t e = dst * row_stride + static_cast<size_t>(head0 + h) * D +
                       threadIdx.x;
      cm.k_pool[e] = store_elem<P>(kx, ks);
      cm.v_pool[e] = store_elem<P>(vx, vs);
    }
    __syncthreads();  // the row and its scales, before the walk reads them
  }

  float m[GC], l[GC], acc[GC][kElems];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[g][e] = 0.f;
  }

  // the warp's row steps: warp-uniform bounds, so every lane takes the
  // shuffles; a lane group's row past r1 loads nothing and adds nothing
  for (int s0 = r0 + warp * kRows; s0 < r1; s0 += kUnroll * kStep) {
    typename L::raw kr[kUnroll], vr[kUnroll];
    float ks[kUnroll], vs[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = s0 + u * kStep + group;
      live[u] = t < r1;
      kr[u] = {};
      vr[u] = {};
      ks[u] = vs[u] = 0.f;
      if (live[u]) {
        const size_t prow =
            kPaged ? static_cast<size_t>(table[t / bs - j0]) * bs + t % bs
                   : static_cast<size_t>(b) * S + t;
        const size_t off = prow * row_stride + head_off;
        if constexpr (kCommit) {  // may read the row this launch wrote
          kr[u] = load_cg<typename L::raw>(k_pool + off);
          vr[u] = load_cg<typename L::raw>(v_pool + off);
          if constexpr (kQuant) {
            ks[u] = load_cg<float>(k_scale + prow);
            vs[u] = load_cg<float>(v_scale + prow);
          }
        } else {
          kr[u] = *reinterpret_cast<const typename L::raw*>(k_pool + off);
          vr[u] = *reinterpret_cast<const typename L::raw*>(v_pool + off);
          if constexpr (kQuant) {
            ks[u] = k_scale[prow];
            vs[u] = v_scale[prow];
          }
        }
      }
    }

    float sc[kUnroll][GC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float kf[kElems];
      widen<P, kElems>(kr[u], kf);
      // int8: q . (codes * scale) as (q . codes) * scale
      const float rs = kQuant ? ks[u] * scale : scale;
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < kElems; ++e) s += qr[g][e] * kf[e];
#pragma unroll
        for (int o2 = kLanes / 2; o2 > 0; o2 >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, o2);
        sc[u][g] = live[u] ? s * rs : kNegInf;
      }
    }

    // online softmax over the batch: one rescale, then its rows
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) mx = fmaxf(mx, sc[u][g]);
      const float corr = expf(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int e = 0; e < kElems; ++e) acc[g][e] *= corr;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      float vf[kElems];
      widen<P, kElems>(vr[u], vf);
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        const float p = expf(sc[u][g] - m[g]);
        l[g] += p;
        // int8: p * (codes * scale) as (p * scale) * codes
        const float pv = kQuant ? p * vs[u] : p;
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[g][e] += pv * vf[e];
      }
    }
  }

  // merge the warp's lane groups, then the warps, in a fixed order
#pragma unroll
  for (int o2 = kLanes; o2 < 32; o2 <<= 1) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], o2);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], o2);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn);
      const float c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        acc[g][e] =
            acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], o2) * c;
      m[g] = mn;
    }
  }
  if (group == 0) {
#pragma unroll
    for (int g = 0; g < GC; ++g) {
#pragma unroll
      for (int e = 0; e < kElems; ++e)
        w_acc[warp][g * D + sub * kElems + e] = acc[g][e];
      if (sub == 0) {
        w_ml[warp][g] = m[g];
        w_ml[warp][GC + g] = l[g];
      }
    }
  }
  __syncthreads();

  // this block's partial in scratch (used only when n_live > 1)
  const size_t slot_head = static_cast<size_t>(b) * gridDim.x + hx;
  float* part = n_live > 1 ? partial + (slot_head * gridDim.z + z) * kPart
                           : nullptr;
  for (int i = threadIdx.x; i < GC * D; i += kThreads) {
    const int g = i / D;
    float mt = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, w_ml[w][g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(w_ml[w][g] - mt);
      lt += w_ml[w][GC + g] * f;
      at += w_acc[w][i] * f;
    }
    if (n_live == 1) {
      o[i] = from_float<T>(at / fmaxf(lt, 1e-30f));
    } else {
      part[i] = at;
      if (i - g * D == 0) {
        part[GC * D + g] = mt;
        part[GC * D + GC + g] = lt;
      }
    }
  }
  if (n_live == 1) return;  // uniform across the block

  // the last split of this (slot, head chunk) to finish merges them all
  __threadfence();
  __syncthreads();
  int* count = counters + slot_head;
  if (threadIdx.x == 0) last = atomicAdd(count, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;  // uniform across the block
  __threadfence();
  const float* first = partial + slot_head * gridDim.z * kPart;
  for (int i = threadIdx.x; i < GC * D; i += kThreads) {
    const int g = i / D;
    float mt = kNegInf;
    for (int s = 0; s < n_live; ++s)
      mt = fmaxf(mt, __ldcg(first + s * kPart + GC * D + g));
    float lt = 0.f, at = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float* ps = first + s * kPart;
      const float f = expf(__ldcg(ps + GC * D + g) - mt);
      lt += __ldcg(ps + GC * D + GC + g) * f;
      at += __ldcg(ps + i) * f;
    }
    o[i] = from_float<T>(at / fmaxf(lt, 1e-30f));
  }
  if (threadIdx.x == 0) *count = 0;
}

template <typename T, typename P, bool kPaged, bool kCommit, int D, int GC>
void launch_g(const dim3 grid, cudaStream_t stream, const void* q,
              const void* k, const void* v, const float* k_scale,
              const float* v_scale, const void* block_tables,
              const void* valid_len, void* out, float* partial,
              int* counters, int KV, int G, int bs, int nb, int S,
              int pool_kv, int head0, int split_rows,
              const Commit<T, P>& cm) {
  flash_decode_kernel<T, P, D, GC, kPaged, kCommit>
      <<<grid, kThreads, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const P*>(k),
          static_cast<const P*>(v), k_scale, v_scale,
          static_cast<const int*>(block_tables),
          static_cast<const int*>(valid_len), static_cast<T*>(out), partial,
          counters, KV, G, bs, nb, S, pool_kv, head0, split_rows, cm);
}

template <typename T, typename P, bool kPaged, bool kCommit, int D>
void launch_d(int B, int KV, int G, cudaStream_t stream, const void* q,
              const void* k, const void* v, const float* k_scale,
              const float* v_scale, const void* block_tables,
              const void* valid_len, void* out, float* partial,
              int* counters, int bs, int nb, int S, int pool_kv, int head0,
              int split_rows, int splits, const Commit<T, P>& cm) {
  // query heads a block: the largest of 4, 2, 1 that divides G
  const int gc = G % 4 == 0 ? 4 : (G % 2 == 0 ? 2 : 1);
  const dim3 grid(KV * (G / gc), B, splits);
#define FD_G(GC)                                                            \
  launch_g<T, P, kPaged, kCommit, D, GC>(                                   \
      grid, stream, q, k, v, k_scale, v_scale, block_tables, valid_len, out, \
      partial, counters, KV, G, bs, nb, S, pool_kv, head0, split_rows, cm)
  if (gc == 4)
    FD_G(4);
  else if (gc == 2)
    FD_G(2);
  else
    FD_G(1);
#undef FD_G
}

// Paged: nb table entries of bs rows; contiguous: nb = 0, S rows a slot.
// The grid covers KV heads, heads head0 .. head0 + KV - 1 of rows of
// pool_kv heads, in splits of split_rows rows.  partial and counters may
// be NULL when one split covers a slot.  kCommit (paged only): cm's new
// rows are committed first.
template <typename T, typename P, bool kPaged, bool kCommit = false>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const float* k_scale, const float* v_scale,
                   const void* block_tables, const void* valid_len, void* out,
                   void* partial, void* counters, int B, int KV, int G,
                   int D, int bs, int nb, int S, int pool_kv, int head0,
                   int split_rows, cudaStream_t stream,
                   const Commit<T, P>& cm = {}) {
  constexpr bool kQuant = std::is_same_v<P, int8_t>;
  if (kQuant && (k_scale == nullptr || v_scale == nullptr))
    return cudaErrorInvalidValue;
  if (head0 < 0 || head0 + KV > pool_kv || G < 1) return cudaErrorInvalidValue;
  if (kCommit && (cm.v_new == nullptr ||
                  (cm.k_amax == nullptr) != (cm.v_amax == nullptr) ||
                  (cm.k_amax != nullptr && !kQuant)))
    return cudaErrorInvalidValue;
  const int rows = kPaged ? nb * bs : S;
  if (split_rows < 1 || (kPaged && (split_rows % bs ||
                                    split_rows / bs > kMaxTable)))
    return cudaErrorInvalidValue;
  const int splits = rows > split_rows ? (rows + split_rows - 1) / split_rows
                                       : 1;
  if (splits > 1 && (partial == nullptr || counters == nullptr))
    return cudaErrorInvalidValue;
  float* pt = static_cast<float*>(partial);
  int* ct = static_cast<int*>(counters);
#define FD_D(DD)                                                              \
  launch_d<T, P, kPaged, kCommit, DD>(B, KV, G, stream, q, k, v, k_scale,     \
                                      v_scale, block_tables, valid_len, out,  \
                                      pt, ct, bs, nb, S, pool_kv, head0,      \
                                      split_rows, splits, cm)
  switch (D) {
    case 16:
      FD_D(16);
      break;
    case 32:
      FD_D(32);
      break;
    case 64:
      FD_D(64);
      break;
    case 128:
      FD_D(128);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef FD_D
  return cudaGetLastError();
}

}  // namespace

// dtype / pool_dtype: 0 = float32, 1 = bfloat16, 2 = int8.  Each returns
// cudaGetLastError() after the launch (0 when the launch was accepted, an
// invalid-value code for a pair that has no instantiation, a head range
// outside the pools, a split that is not whole table blocks, missing
// scratch, or commit arguments out of pairs); never synchronises.  The
// paged launch attends the KV heads of q (B, KV, G, D) over pool heads
// head0 .. head0 + KV - 1 of pools whose rows hold pool_kv heads.
// partial: B * KV * splits * G * (D + 2) floats and counters: B * KV * G
// ints, zero, where splits = ceil(nb * bs / split_rows) > 1; the kernel
// leaves the counters zero.  With k_new and v_new ((B, KV, D) in q's
// dtype) it first commits slot b's new row at position valid_len[b] - 1
// through its table, as flash_commit_paged_launch with q_len 1 and q_start
// valid_len - 1 would (k_amax/v_amax (B,) fp32 or NULL, int8 pools only),
// writing the pools and scales in place.
extern "C" int flash_decode_paged_launch(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* valid_len, void* out, void* partial, void* counters,
    const void* k_new, const void* v_new, const void* k_amax,
    const void* v_amax, int B, int KV, int G, int D, int bs, int nb,
    int pool_kv, int head0, int split_rows, int dtype, int pool_dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
#define FD_PAGED(T, P)                                                       \
  {                                                                          \
    if (k_new == nullptr)                                                    \
      return static_cast<int>(launch<T, P, true>(                            \
          q, k_pool, v_pool, ks, vs, block_tables, valid_len, out, partial,  \
          counters, B, KV, G, D, bs, nb, 0, pool_kv, head0, split_rows,      \
          st));                                                              \
    return static_cast<int>(launch<T, P, true, true>(                        \
        q, k_pool, v_pool, ks, vs, block_tables, valid_len, out, partial,    \
        counters, B, KV, G, D, bs, nb, 0, pool_kv, head0, split_rows, st,    \
        Commit<T, P>{static_cast<const T*>(k_new),                           \
                     static_cast<const T*>(v_new),                           \
                     static_cast<const float*>(k_amax),                      \
                     static_cast<const float*>(v_amax),                      \
                     static_cast<P*>(const_cast<void*>(k_pool)),             \
                     static_cast<P*>(const_cast<void*>(v_pool)),             \
                     static_cast<float*>(const_cast<void*>(k_scale)),        \
                     static_cast<float*>(const_cast<void*>(v_scale))}));     \
  }
  if (dtype == 0 && pool_dtype == 0) FD_PAGED(float, float);
  if (dtype == 0 && pool_dtype == 1) FD_PAGED(float, __nv_bfloat16);
  if (dtype == 0 && pool_dtype == 2) FD_PAGED(float, int8_t);
  if (dtype == 1 && pool_dtype == 1) FD_PAGED(__nv_bfloat16, __nv_bfloat16);
  if (dtype == 1 && pool_dtype == 2) FD_PAGED(__nv_bfloat16, int8_t);
#undef FD_PAGED
  return static_cast<int>(cudaErrorInvalidValue);
}

// The contiguous cache k/v (B, S, KV, D) in q's dtype (0 or 1), in splits
// of split_rows rows; partial and counters as for the paged launch with S
// in place of nb * bs.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* valid_len,
                                   void* out, void* partial, void* counters,
                                   int B, int KV, int G, int D, int S,
                                   int split_rows, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float, float, false>(
        q, k, v, nullptr, nullptr, nullptr, valid_len, out, partial,
        counters, B, KV, G, D, 1, 0, S, KV, 0, split_rows, st));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16, __nv_bfloat16, false>(
        q, k, v, nullptr, nullptr, nullptr, valid_len, out, partial,
        counters, B, KV, G, D, 1, 0, S, KV, 0, split_rows, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
