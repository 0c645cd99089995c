// The order in which the GEMM routes' blocks walk the output tiles: a 1-D
// grid, one block a BM x BN tile of C, GROUP block rows at a time down each
// column of tiles, then the next column.  The blocks in flight then share
// their rows of A and columns of B in the L2.  gemm/kernel.py::tile_origin
// is the same function, held by the CPU tests.
#pragma once

template <int BM, int BN, int GROUP>
__device__ __forceinline__ void gemm_tile_origin(int M, int N, int &m0,
                                                 int &n0) {
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int span = GROUP * tiles_n;
  const int block = blockIdx.x;
  const int first = (block / span) * GROUP;
  const int rows = tiles_m - first < GROUP ? tiles_m - first : GROUP;
  m0 = (first + (block % span) % rows) * BM;
  n0 = ((block % span) / rows) * BN;
}
