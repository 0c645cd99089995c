"""GEMM: the wrapper of the two CUDA routes in ``csrc/``, across from
:mod:`repro.kernels.gemm.kernel`.

:func:`gemm` checks the tile keywords as the reference does (each is
clamped to its dimension and must divide it), then takes CPU tensors to the
plain version in ``ref.py`` and launches one CUDA route for CUDA tensors;
there is no fallback from one to the other, nor from one route to the
other.  ``bm/bn/bk`` are the TPU kernel's tiles; the CUDA routes' tiles are
their own, and :func:`gemm_plan` picks the route and sizes its launch from
the dtype, the shape and the operands' alignment alone:

* ``"wgmma"`` (``csrc/gemm_wgmma.cu``): bf16 on the tensor cores, TMA
  loads into a ring of shared-memory stages; it takes bf16 whenever TMA can
  address both operands (K and N multiples of 8, so that rows are whole
  16-byte units, and 16-byte-aligned base pointers);
* ``"simt"`` (``csrc/gemm_simt.cu``): fp32 on the CUDA cores (TF32 stays
  off, so fp32 has no tensor-core path), and bf16 that TMA cannot address.

Each route has launch variants (:data:`VARIANTS`), the tuner's space
(:mod:`repro_torch.tuning.spaces`): the keywords ``tile_m``, ``tile_n``,
``tile_k`` and ``stages`` name one of the planned route's, each left out
taking the route's default (today's tile, :data:`WGMMA_TILE` and
:data:`SIMT_TILE`), and :func:`gemm_plan` raises on a combination the route
has not compiled.  The default variants are built in ``csrc/gemm_wgmma.cu``
and ``csrc/gemm_simt.cu``, the others in the ``*_variants.cu`` beside them.

:func:`gemm_plain` runs the plain version on any device, with the same
checks.  ``gemm.launches`` counts the calls that launched a kernel,
``gemm.route_launches`` the same calls by route and
``gemm.variant_launches`` by (route, tile_m, tile_n, tile_k, stages).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.gemm import ref

#: dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("wgmma", "simt")
#: block tile (bm, bn, bk) and stages of each route's default variant, as
#: the sources define
WGMMA_TILE, WGMMA_STAGES = (128, 256, 64), 4
SIMT_TILE, SIMT_STAGES = (128, 128, 16), 2
#: route -> its compiled launch variants (tile_m, tile_n, tile_k, stages),
#: the default first
VARIANTS = {
    "wgmma": ((*WGMMA_TILE, WGMMA_STAGES), (128, 256, 64, 3),
              (128, 128, 64, 4)),
    "simt": ((*SIMT_TILE, SIMT_STAGES), (128, 64, 16, 2), (64, 64, 16, 2)),
}
#: tiles of this many block rows are walked column by column, so that the
#: blocks in flight share their A rows and B columns in the L2
GROUP_M = 16
#: dynamic shared memory a block may opt into on an H100 (227 KB)
SMEM_LIMIT = 232448
_MAX_GRID = 2 ** 31 - 1
_ARGTYPES = {
    "gemm_wgmma": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
    + [ctypes.c_void_p],
    "gemm_wgmma_variants": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
    + [ctypes.c_void_p],
    "gemm_simt": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9
    + [ctypes.c_void_p],
    "gemm_simt_variants": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11
    + [ctypes.c_void_p],
}


class GemmPlan(NamedTuple):
    """How one product is launched: the ``route`` ("wgmma" or "simt"), its
    block ``tile`` (bm, bn, bk), the ``stages`` of its K slices in shared
    memory, the ``smem`` bytes a block, the ``grid`` (blocks, one a tile),
    and for the simt route whether A, B and C are read or written as
    16-byte vectors (``vec_a``, ``vec_b``, ``vec_c``) and whether every
    tile lies inside M, N and K with both operands read as vectors
    (``whole_tiles``: the kernel then checks no edge)."""

    route: str
    tile: Tuple[int, int, int]
    stages: int
    smem: int
    grid: int
    vec_a: bool
    vec_b: bool
    vec_c: bool
    whole_tiles: bool


def variant(route: str, tile_m=None, tile_n=None, tile_k=None,
            stages=None) -> Tuple[int, int, int, int]:
    """The launch variant of ``route`` the keywords name, each one left
    out (None) taking the route's default; raises when the route has not
    compiled it."""
    default = VARIANTS[route][0]
    got = tuple(d if v is None else v for v, d in
                zip((tile_m, tile_n, tile_k, stages), default))
    if got not in VARIANTS[route]:
        raise ValueError(f"gemm route {route} has no launch variant "
                         f"(tile_m, tile_n, tile_k, stages) = {got}; it has "
                         f"{VARIANTS[route]}")
    return got


@functools.lru_cache(maxsize=256)
def gemm_plan(M: int, N: int, K: int, dtype: torch.dtype,
              aligned: bool = True, tile_m=None, tile_n=None, tile_k=None,
              stages=None) -> GemmPlan:
    """The route and launch of an (M, K) @ (K, N) product in ``dtype``;
    ``aligned``: both operands start on a 16-byte boundary; ``tile_m``,
    ``tile_n``, ``tile_k`` and ``stages`` name a launch variant of the
    route (:func:`variant`), by default the route's default.

    bf16 takes the wgmma route when K % 8 == 0, N % 8 == 0 and ``aligned``:
    a 128 x 256 tile a block, a ring of 4 stages of 64-deep K slices (A
    128 x 64 and B 64 x 256 in bf16, 48 KB a stage), 1 KB to align the ring
    to the 128-byte swizzle's 1024-byte period, and a full and an empty
    barrier (8 bytes each) a stage.  Everything else takes the simt route:
    a 128 x 128 tile, 2 stages of 16-deep slices held in fp32.  There, a
    row of A (B, C) is moved in 16-byte vectors only when ``aligned`` and K
    (N, N) is a multiple of the elements in 16 bytes; C is allocated by the
    wrapper, so it is always aligned; ``whole_tiles`` when both operands
    are vectors and the tile divides M, N and K.  The other variants change
    the tile and the stages in these formulas.  Raises on a shape no route
    takes and on a variant the route has not compiled.
    """
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"gemm takes float32 or bfloat16, got {dtype}")
    if min(M, N, K) < 1 or max(M, N, K) > 2 ** 31 - 1:
        raise ValueError(f"gemm cannot take ({M}, {N}, {K})")
    if dtype == torch.bfloat16 and K % 8 == 0 and N % 8 == 0 and aligned:
        route = "wgmma"
        *tile, stages = variant(route, tile_m, tile_n, tile_k, stages)
        bm, bn, bk = tile = tuple(tile)
        smem = stages * (bm * bk + bk * bn) * 2 + 1024 + 2 * stages * 8
        vec_a = vec_b = vec_c = whole = False
    else:
        route = "simt"
        *tile, stages = variant(route, tile_m, tile_n, tile_k, stages)
        bm, bn, bk = tile = tuple(tile)
        smem = stages * (bm * bk + bk * bn) * 4
        per = 16 // dtype.itemsize
        vec_a, vec_b, vec_c = aligned and K % per == 0, \
            aligned and N % per == 0, N % 4 == 0
        whole = (vec_a and vec_b and M % bm == 0 and N % bn == 0
                 and K % bk == 0)
    grid = -(-M // bm) * -(-N // bn)
    if grid > _MAX_GRID:
        raise ValueError(f"gemm ({M}, {N}, {K}) needs {grid} blocks, over "
                         f"{_MAX_GRID}")
    if smem > SMEM_LIMIT:
        raise ValueError(f"gemm {route} needs {smem} bytes of shared memory, "
                         f"over {SMEM_LIMIT}")
    return GemmPlan(route, tile, stages, smem, grid, vec_a, vec_b, vec_c,
                    whole)


def tile_origin(block: int, M: int, N: int, plan: GemmPlan
                ) -> Tuple[int, int]:
    """(first row, first column) of C that block ``block`` computes, in
    the order both sources walk the tiles: :data:`GROUP_M` block rows at a
    time, down each column of tiles, then the next column."""
    bm, bn, _ = plan.tile
    tiles_m, tiles_n = -(-M // bm), -(-N // bn)
    span = GROUP_M * tiles_n
    first = (block // span) * GROUP_M
    rows = min(tiles_m - first, GROUP_M)
    tm = first + (block % span) % rows
    tn = (block % span) // rows
    return tm * bm, tn * bn


def _check(x, y, bm: int, bn: int, bk: int) -> int:
    """Checks; returns the clamped bk."""
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"gemm needs (M, K) @ (K, N), got {tuple(x.shape)} "
                         f"@ {tuple(y.shape)}")
    M, K = x.shape
    N = y.shape[1]
    bm, bn, bk = min(bm, M), min(bn, N), min(bk, K)
    if min(bm, bn, bk) <= 0 or M % bm or N % bn or K % bk:
        raise ValueError(f"({M},{N},{K}) not divisible by tile "
                         f"({bm},{bn},{bk})")
    if x.dtype not in _DTYPE_CODE or y.dtype != x.dtype:
        raise TypeError(f"gemm inputs must both be float32 or bfloat16, got "
                        f"{x.dtype} and {y.dtype}")
    if x.device != y.device:
        raise ValueError(f"gemm inputs on {x.device} and {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("gemm inputs must be contiguous")
    return bk


def _plan(x, y, tile_m, tile_n, tile_k, stages) -> GemmPlan:
    M, K = x.shape
    return gemm_plan(M, y.shape[1], K, x.dtype,
                     x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0,
                     tile_m, tile_n, tile_k, stages)


def gemm(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128, bn: int = 128,
         bk: int = 128, tile_m=None, tile_n=None, tile_k=None,
         stages=None) -> torch.Tensor:
    """x (M, K) @ y (K, N) -> (M, N) in x's dtype, fp32 accumulation."""
    bk = _check(x, y, bm, bn, bk)
    plan = _plan(x, y, tile_m, tile_n, tile_k, stages)
    if x.device.type == "cpu":
        return ref.gemm_plain(x, y, bk)
    build.require_cuda("gemm", (x, y))
    M, K = x.shape
    N = y.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    key = (plan.route, *plan.tile, plan.stages)
    default = key[1:] == VARIANTS[plan.route][0]
    library = f"gemm_{plan.route}" + ("" if default else "_variants")
    symbol = f"gemm_{plan.route}_" + ("launch" if default
                                      else "variant_launch")
    fn = build.function(library, symbol, _ARGTYPES[library])
    args = [x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K]
    if plan.route == "wgmma":
        args += [] if default else [plan.tile[1], plan.stages]
        args += [plan.grid, plan.smem, x.device.index]
    else:
        args += [_DTYPE_CODE[x.dtype], plan.vec_a, plan.vec_b, plan.vec_c,
                 plan.whole_tiles]
        args += [] if default else [plan.tile[0], plan.tile[1]]
        args += [plan.grid]
    err = fn(*args, build.stream_of(x))
    build.raise_on(library, err)
    gemm.launches += 1
    gemm.route_launches[plan.route] += 1
    gemm.variant_launches[key] = gemm.variant_launches.get(key, 0) + 1
    return out


gemm.launches = 0
gemm.route_launches = dict.fromkeys(ROUTES, 0)
gemm.variant_launches = {}


def gemm_plain(x: torch.Tensor, y: torch.Tensor, *, bm: int = 128,
               bn: int = 128, bk: int = 128, tile_m=None, tile_n=None,
               tile_k=None, stages=None) -> torch.Tensor:
    bk = _check(x, y, bm, bn, bk)
    _plan(x, y, tile_m, tile_n, tile_k, stages)
    return ref.gemm_plain(x, y, bk)
