"""The host-side plan of the GEMM's two CUDA routes, and the port's GEMM
against the reference's at the shapes the card tests use.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``); what picks the route and sizes the launch is Python,
and is held here:

* the route depends on the dtype, K % 8, N % 8 and the operands'
  alignment only (never on M), and fp32 always takes ``simt``;
* the tiles, walked in the kernels' order (``tile_origin``), cover every
  output element exactly once at edge shapes;
* a route's stages fit an H100 block's 227 KB, and the plan's tiles,
  stages and tile order are the ones the CUDA sources define;
* the plan raises where no route takes the shape;
* on the CPU ``gemm`` runs the plain version only, on the same numpy inputs
  as the JAX ``gemm`` (interpret mode) and within the GEMM tolerance of
  ``tests/test_torch_hpc_kernels.py`` (fp32 1e-5 * max|ref|, bf16 plus one
  bf16 ulp: fp32 sums in another order, then one rounding).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.gemm import kernel as jgemm  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.gemm import kernel  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

CSRC = Path(kernel.__file__).resolve().parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16
EDGE_SHAPES = [(1, 1), (1, 8), (7, 9), (128, 256), (129, 257), (300, 520),
               (1000, 1000), (2049, 129), (4096, 300), (127, 2056)]


def _route(M, N, K, dtype, aligned=True):
    return kernel.gemm_plan(M, N, K, dtype, aligned).route


def _origins(M, N, plan):
    return [kernel.tile_origin(b, M, N, plan) for b in range(plan.grid)]


@pytest.mark.parametrize("K", [1, 7, 8, 12, 16, 64, 200, 4096])
@pytest.mark.parametrize("N", [1, 8, 12, 136, 260, 264])
@pytest.mark.parametrize("aligned", [True, False])
def test_route_depends_on_dtype_k_n_and_alignment_only(K, N, aligned):
    want = "wgmma" if K % 8 == 0 and N % 8 == 0 and aligned else "simt"
    assert {_route(M, N, K, BF16, aligned) for M in (1, 64, 129, 8192)} == \
        {want}
    assert {_route(M, N, K, F32, aligned) for M in (1, 64, 129, 8192)} == \
        {"simt"}


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("M,N", EDGE_SHAPES)
def test_tiles_cover_every_output_element_once(dtype, M, N):
    plan = kernel.gemm_plan(M, N, 64, dtype)
    bm, bn, _ = plan.tile
    seen = np.zeros((M, N), dtype=np.int32)
    origins = _origins(M, N, plan)
    assert len(origins) == plan.grid == -(-M // bm) * -(-N // bn)
    for m0, n0 in origins:
        assert 0 <= m0 < M and 0 <= n0 < N
        assert m0 % bm == 0 and n0 % bn == 0
        seen[m0:m0 + bm, n0:n0 + bn] += 1
    assert (seen == 1).all()


def test_tiles_walk_group_m_block_rows_down_each_column():
    plan = kernel.gemm_plan(8192, 8192, 8192, F32)
    bm, bn, _ = plan.tile
    first = _origins(8192, 8192, plan)[:kernel.GROUP_M + 1]
    assert first[:kernel.GROUP_M] == [(i * bm, 0)
                                      for i in range(kernel.GROUP_M)]
    assert first[kernel.GROUP_M] == (0, bn)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_stages_fit_an_h100_block(dtype):
    plan = kernel.gemm_plan(8192, 8192, 8192, dtype)
    bm, bn, bk = plan.tile
    item = 2 if plan.route == "wgmma" else 4  # simt stages hold fp32
    ring = plan.stages * (bm * bk + bk * bn) * item
    assert ring <= plan.smem <= kernel.SMEM_LIMIT == 227 * 1024
    assert plan.stages >= 2
    if plan.route == "wgmma":
        # the ring, 1 KB of alignment, a full and an empty barrier a stage
        assert plan.smem == ring + 1024 + 16 * plan.stages
        assert bk * 2 == 128  # a K slice is one 128-byte swizzle row


def _constants(source: str) -> dict:
    """The constants of a route's default variant: its source and the
    header that holds the kernel template."""
    text = (CSRC / source).read_text() + (CSRC / source).with_suffix(
        ".cuh").read_text()
    return {name: int(value) for name, value in
            re.findall(r"\b(k[A-Z]\w*) = (\d+)\b", text)}


@pytest.mark.parametrize("route,source", [("wgmma", "gemm_wgmma.cu"),
                                          ("simt", "gemm_simt.cu")])
def test_plan_matches_the_cuda_source(route, source):
    got = _constants(source)
    dtype = BF16 if route == "wgmma" else F32
    plan = kernel.gemm_plan(4096, 4096, 4096, dtype)
    assert plan.route == route
    assert (got["kBM"], got["kBN"], got["kBK"]) == plan.tile
    assert got["kGroupM"] == kernel.GROUP_M
    if route == "wgmma":
        assert got["kStages"] == plan.stages
    lib = build.LIBRARIES[f"gemm_{route}"]
    assert lib[0] == CSRC / source
    assert lib[1] == f"gemm_{route}_error_string"


def test_simt_vectors_only_where_alignment_allows():
    p = kernel.gemm_plan(100, 12, 8, F32)
    assert (p.vec_a, p.vec_b, p.vec_c) == (True, True, True)
    p = kernel.gemm_plan(100, 13, 6, F32)
    assert (p.vec_a, p.vec_b, p.vec_c) == (False, False, False)
    p = kernel.gemm_plan(100, 12, 8, F32, aligned=False)
    assert (p.vec_a, p.vec_b, p.vec_c) == (False, False, True)
    p = kernel.gemm_plan(100, 12, 16, BF16)  # 8 bf16 in 16 bytes
    assert (p.route, p.vec_a, p.vec_b, p.vec_c) == ("simt", True, False,
                                                    True)
    assert not kernel.gemm_plan(64, 64, 64, BF16).vec_a  # wgmma: TMA


@pytest.mark.parametrize("M,N,K,aligned,whole", [
    (8192, 8192, 8192, True, True), (128, 256, 16, True, True),
    (129, 256, 16, True, False), (128, 260, 16, True, False),
    (128, 256, 24, True, False), (128, 256, 16, False, False),
])
def test_simt_skips_edge_checks_only_for_whole_vector_tiles(M, N, K, aligned,
                                                           whole):
    plan = kernel.gemm_plan(M, N, K, F32, aligned)
    assert plan.whole_tiles == whole
    if whole:  # every tile inside the product, every row a vector
        bm, bn, bk = plan.tile
        assert plan.vec_a and plan.vec_b and plan.vec_c
        assert M % bm == 0 and N % bn == 0 and K % bk == 0


@pytest.mark.parametrize("M,N,K,dtype,error", [
    (0, 8, 8, BF16, ValueError),
    (8, 0, 8, F32, ValueError),
    (8, 8, 0, F32, ValueError),
    (2 ** 31, 8, 8, F32, ValueError),
    (2 ** 31 - 1, 2 ** 31 - 1, 8, BF16, ValueError),  # blocks past 2^31
    (8, 8, 8, torch.float16, TypeError),
    (8, 8, 8, torch.float64, TypeError),
])
def test_plan_raises_where_no_route_takes_the_shape(M, N, K, dtype, error):
    with pytest.raises(error):
        kernel.gemm_plan(M, N, K, dtype)


def test_cpu_gemm_runs_only_the_plain_version(monkeypatch):
    def no_kernel(*args, **kwargs):
        raise AssertionError("a CPU tensor reached a CUDA route")

    monkeypatch.setattr(build, "function", no_kernel)
    monkeypatch.setattr(build, "build", no_kernel)
    before = (kernel.gemm.launches, dict(kernel.gemm.route_launches))
    x, y = torch.ones(8, 16, dtype=BF16), torch.ones(16, 24, dtype=BF16)
    torch.testing.assert_close(kernel.gemm(x, y),
                               kernel.gemm_plain(x, y), rtol=0, atol=0)
    assert (kernel.gemm.launches, kernel.gemm.route_launches) == before


def _ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("M,N,K,dtype", [
    (1, 8, 8, "bfloat16"), (100, 136, 8, "bfloat16"),
    (130, 264, 200, "bfloat16"), (128, 256, 64, "bfloat16"),
    (100, 130, 70, "float32"), (257, 129, 33, "float32"),
    (300, 260, 100, "float32"), (129, 264, 72, "bfloat16"),
])
def test_gemm_at_the_card_shapes_matches_reference(M, N, K, dtype):
    """The card tests' shapes (both routes' edges) with whole-dimension
    tiles, as ``chip_smoke.py`` calls them, against the JAX kernel."""
    rng = np.random.default_rng(M * N + K)
    jx = jnp.asarray(rng.standard_normal((M, K)), getattr(jnp, dtype))
    jy = jnp.asarray(rng.standard_normal((K, N)), getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    ty = torch.from_numpy(np.array(jy.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = kernel.gemm(tx, ty, bm=M, bn=N, bk=K).float().numpy()
    want = np.asarray(jgemm.gemm(jx, jy, bm=M, bn=N, bk=K).astype(
        jnp.float32))
    tol = 1e-5 * np.abs(want).max()
    if dtype == "bfloat16":
        tol = tol + _ulp(want)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
