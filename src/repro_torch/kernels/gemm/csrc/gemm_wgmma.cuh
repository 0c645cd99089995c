// GEMM, route "wgmma", for Hopper (sm_90a): C = A @ B in bf16 on the tensor
// cores.
//
// Replaces the TPU kernel src/repro/kernels/gemm/kernel.py::gemm
// (_gemm_kernel) for bf16: (M, K) @ (K, N) with an fp32 accumulator and one
// flush, cast to bf16.  The TPU walked K as the sequential, innermost grid
// axis and kept the accumulator in VMEM scratch; here each block owns one
// 128 x 256 tile of C, keeps its accumulator in registers and walks K in a
// loop, through a ring of shared-memory stages that TMA fills.
//
// Bound: operations (2MNK flops; an 8192^3 product is 1.1 TFLOP against
// 0.4 GB moved, 1.11 ms at the 989 TFLOP/s bf16 peak).  Only wgmma reaches
// that peak, so the design keeps the tensor cores fed:
// - 384 threads a block: warpgroup 0 is the producer, warpgroups 1 and 2
//   the consumers.  setmaxnreg moves registers from the producer (40) to
//   the consumers (232): a consumer's 64 x 256 fp32 accumulator is 128
//   registers a thread.
// - One producer thread keeps a ring of 4 stages full: a stage is a 64-deep
//   K slice, A's 128 x 64 box (16 KB) and four of B's 64 x 64 boxes (8 KB
//   each), loaded by cp.async.bulk.tensor with 128-byte swizzle and
//   completed on the stage's "full" mbarrier by their byte count.
// - Each consumer waits on a stage's full barrier, issues four
//   m64n256k16 products on its 64 rows of A and all of B (one commit
//   group), and waits until at most this group is in flight: the previous
//   stage's products have retired, so one thread a consumer then arrives on
//   that stage's "empty" barrier (count 2), and the producer refills it.
// - Shared layouts, as TMA's 128-byte swizzle writes them: A is K-major,
//   rows of 128 bytes in 8-row atoms of 1024 bytes (descriptor: stride 1024
//   bytes between 8-row groups; a 16-deep step moves the start 32 bytes).
//   B is (K, N) row-major, so MN-major for wgmma (imm-trans-b = 1): box j
//   holds columns 64j..64j+63 as 64 rows of k, 128 bytes each; its
//   descriptor's leading byte offset (next 64 columns) is one box, 8192
//   bytes, and its stride byte offset (next 8 k) 1024; a 16-deep step
//   moves the start 2048 bytes.
// - Tiles are walked GROUP_M block rows at a time (csrc/gemm_tiles.cuh),
//   so the blocks in flight share A's rows and B's columns in the L2.
// A wait on a barrier that exceeds 10 s traps, so a fault in the ring ends
// the launch with an error instead of hanging the card.
//
// Numerics: products summed in fp32 (the tensor cores' accumulation) along
// K in slices of 16; the fp32 tile is rounded to bf16 once, as
// preferred_element_type=f32 then astype does.  Edges: TMA fills the parts
// of a box past M, N or K with zeros, so any M and any K, N multiples of 8
// work; stores past M or N are dropped.  kernel.gemm_plan sends bf16 here
// only when K % 8 == 0, N % 8 == 0 (row strides whole 16-byte units, as TMA
// needs) and both operands are 16-byte aligned.
//
// The tensor maps are encoded on the host by libcuda's
// cuTensorMapEncodeTiled, found through cudaGetDriverEntryPoint, so the
// library links only the runtime; each is passed as a __grid_constant__
// kernel parameter.
//
// Launch variants: the kernel is a template over the tile's width BN and
// the ring's stages.  gemm_wgmma.cu instantiates the default, 128 x 256 x
// 64 in 4 stages (the tile and ring above); gemm_wgmma_variants.cu the
// tuner's other two, 128 x 256 x 64 in 3 stages and 128 x 128 x 64 in 4
// (m64n128k16 products, 64 accumulators a consumer thread).  kernel.py's
// gemm_plan names the variant and its shared memory.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tiles.cuh"

namespace {

constexpr int kBM = 128, kBK = 64;
constexpr int kGroupM = 16;
constexpr int kThreads = 384;  // a producer and two consumer warpgroups
constexpr int kConsumers = 2;
constexpr int kBoxN = 64;  // a B box: 64 columns (one 128-byte swizzle row)
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBBoxBytes = kBK * kBoxN * 2;
template <int BN>
constexpr int kStageBytes = kABytes + BN * kBK * 2;
// the ring, 1 KB to align it to the swizzle's period, the barriers
template <int BN, int STAGES>
constexpr int kSmemBytes = STAGES * kStageBytes<BN> + 1024 + 2 * STAGES * 8;
constexpr int kMaxDevices = 64;
constexpr uint64_t kWaitLimitNs = 10000000000ull;
constexpr int kNoEncoder = 1 << 20;
constexpr int kEncodeFailed = 2 << 20;

__device__ __forceinline__ uint32_t smem_u32(const void *p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap *map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// A shared-memory matrix descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous products' fences and waits.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One m64n256k16 product of the warpgroup: d += A (64 x 16, K-major) @
// B (16 x 256, MN-major: imm-trans-b = 1), both read from shared memory
// through their descriptors, d in this thread's 128 fp32 registers.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// The same product over 128 columns of B: d in 64 fp32 registers.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// One product of the tile's width: m64n256k16 or m64n128k16.
__device__ __forceinline__ void wgmma_tile(float (&d)[128], uint64_t da,
                                           uint64_t db) {
  wgmma_m64n256k16(d, da, db);
}
__device__ __forceinline__ void wgmma_tile(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  wgmma_m64n128k16(d, da, db);
}

template <int BN, int STAGES>
__global__ void __launch_bounds__(kThreads, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_b,
                  __nv_bfloat16 *__restrict__ C, int M, int N, int K) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  uint8_t *smem = smem_raw + pad;
  const uint32_t ring = smem_u32(smem);
  const uint32_t full = ring + STAGES * kStageBytes<BN>;  // STAGES barriers
  const uint32_t empty = full + STAGES * 8;              // STAGES barriers
  const int k_tiles = (K + kBK - 1) / kBK;
  int m0, n0;
  gemm_tile_origin<kBM, BN, kGroupM>(M, N, m0, n0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int i = 0; i < k_tiles; ++i) {
        const int s = i % STAGES;
        // a fresh barrier has completed the phase before its first, so
        // the first round's waits (parity 1) pass at once
        mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
        const uint32_t bar = full + 8 * s;
        const uint32_t stage = ring + s * kStageBytes<BN>;
        mbar_expect_tx(bar, kStageBytes<BN>);
        tma_load(stage, &map_a, bar, i * kBK, m0);
#pragma unroll
        for (int j = 0; j < BN / kBoxN; ++j)
          tma_load(stage + kABytes + j * kBBoxBytes, &map_b, bar,
                   n0 + j * kBoxN, i * kBK);
      }
    }
  } else {  // a consumer warpgroup: 64 rows of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    float d[BN / 2];  // 64 rows x BN columns over 128 threads
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
    fence_operands(d);
    for (int i = 0; i < k_tiles; ++i) {
      const int s = i % STAGES;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      const uint32_t stage = ring + s * kStageBytes<BN>;
      const uint64_t da = make_desc(stage + c * 64 * kBK * 2, 16, 1024);
      const uint64_t db = make_desc(stage + kABytes, kBBoxBytes, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_tile(d, da + 2 * kk, db + 128 * kk);
      wgmma_commit();
      wgmma_wait<1>();
      if (i > 0 && t == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
    }
    wgmma_wait<0>();
    fence_operands(d);

    // d[4j..4j+3]: rows r and r + 8, columns 8j + 2 (t % 4) and the next
    const int row = m0 + c * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col0 = n0 + (t % 4) * 2;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
      if (col >= N) continue;  // N is even, so col + 1 < N too
      if (row < M)
        *reinterpret_cast<__nv_bfloat162 *>(C + (int64_t)row * N + col) =
            __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
      if (row + 8 < M)
        *reinterpret_cast<__nv_bfloat162 *>(C + (int64_t)(row + 8) * N +
                                            col) =
            __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap *, CUtensorMapDataType,
                                 cuuint32_t, void *, const cuuint64_t *,
                                 const cuuint64_t *, const cuuint32_t *,
                                 const cuuint32_t *, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void *p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major bf16 (rows, cols) matrix, read in boxes of box_rows x
// box_cols with 128-byte swizzle; parts of a box past the matrix read 0.
CUresult encode_map(EncodeTiled encode, CUtensorMap *map, const void *ptr,
                    uint64_t rows, uint64_t cols, uint32_t box_rows,
                    uint32_t box_cols) {
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void *>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Checks the launch against this variant, encodes the tensor maps and
// launches; returns a cudaError_t or one of this file's codes.
template <int BN, int STAGES>
int launch(const void *a, const void *b, void *c, int M, int N, int K,
           int grid, int smem, int device, cudaStream_t stream) {
  constexpr int kSmem = kSmemBytes<BN, STAGES>;
  const int64_t tiles =
      (int64_t)((M + kBM - 1) / kBM) * ((N + BN - 1) / BN);
  if (M < 1 || N < 1 || K < 1 || K % 8 || N % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || smem != kSmem || grid != tiles)
    return cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kNoEncoder;
  CUtensorMap map_a, map_b;
  CUresult r = encode_map(encode, &map_a, a, M, K, kBM, kBK);
  if (r == CUDA_SUCCESS) r = encode_map(encode, &map_b, b, K, N, kBK, kBoxN);
  if (r != CUDA_SUCCESS) return kEncodeFailed + static_cast<int>(r);
  static bool raised[kMaxDevices] = {};
  if (!raised[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_wgmma_kernel<BN, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    raised[device] = true;
  }
  gemm_wgmma_kernel<BN, STAGES><<<grid, kThreads, smem, stream>>>(
      map_a, map_b, static_cast<__nv_bfloat16 *>(c), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Names a code of either library of this route.
extern "C" const char *gemm_wgmma_error_string(int code) {
  if (code == kNoEncoder)
    return "libcuda has no cuTensorMapEncodeTiled";
  if (code >= kEncodeFailed)
    return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
