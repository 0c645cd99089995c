"""The host-side plan of the block-ELL SpMV kernel, its index walk, and the
plain versions at the plan's edges against the reference's kernels.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``); what picks its instantiation is Python, held here:

* ``spmv_plan`` picks 16-byte vectors only for aligned inputs whose width
  is a multiple of the vector, else the scalar route, and sizes the lanes
  a row as the kernel's constants say;
* a numpy emulation of the kernel's loops (warps of ``rows * unroll``
  rows, warp-uniform passes of ``lanes * vec`` elements) visits every live
  lane of every row exactly once, never loads a vector that lies wholly
  past ``row_nnz`` in the predicated variant, and loads and gathers every
  lane of the padded width in the fixed-width variant;
* the plan's constants are the ones ``csrc/spmv.cu`` defines;
* at the plan's edge widths and at ``row_nnz`` of 0, negative and past the
  width, the plain versions agree with the JAX ``spmv_blockell`` and
  ``spmv_fixed_width`` in interpret mode within the tolerances of
  ``tests/test_torch_hpc_kernels.py``: fp32 rtol 1e-5, atol 1e-6 (row sums
  in another order); bf16 one bf16 ulp of max|y| (the reference rounds its
  row sums to bf16, the port once at the end);
* the gather probe's columns are the 32-bit mix its CUDA source computes.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.spmv import kernel as jspmv  # noqa: E402
from repro_torch.kernels.spmv import kernel, ref  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

CSRC = Path(kernel.__file__).resolve().parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16
EDGE_WIDTHS = [1, 3, 4, 100, 128, 130, 256]
_JNP = {F32: jnp.float32, BF16: jnp.bfloat16}


@pytest.mark.parametrize("width,dtype,predicated,aligned,want", [
    (128, F32, True, True, (8, 4, 4, kernel.UNROLL)),
    (128, BF16, True, True, (4, 8, 8, kernel.UNROLL)),
    (128, F32, False, True, (32, 1, 4, kernel.UNROLL)),
    (128, BF16, False, True, (16, 2, 8, kernel.UNROLL)),
    (256, BF16, False, True, (32, 1, 8, kernel.UNROLL)),
    (64, F32, False, True, (16, 2, 4, kernel.UNROLL)),
    (4, F32, False, True, (8, 4, 4, kernel.UNROLL)),
    (100, F32, True, True, (8, 4, 4, kernel.UNROLL)),
    (100, BF16, True, True, (32, 1, 1, kernel.UNROLL_SCALAR)),
    (130, F32, False, True, (32, 1, 1, kernel.UNROLL_SCALAR)),
    (1, F32, True, True, (32, 1, 1, kernel.UNROLL_SCALAR)),
    (128, F32, True, False, (32, 1, 1, kernel.UNROLL_SCALAR)),
    (128, BF16, False, False, (32, 1, 1, kernel.UNROLL_SCALAR)),
])
def test_plan_picks_vectors_by_width_and_alignment(width, dtype, predicated,
                                                   aligned, want):
    plan = kernel.spmv_plan(width, dtype, predicated, aligned)
    assert tuple(plan) == want
    assert plan.lanes * plan.rows == 32
    assert plan.vec * dtype.itemsize in ((16,) if plan.vec > 1
                                         else (dtype.itemsize,))


@pytest.mark.parametrize("width", [0, -3])
def test_plan_refuses_what_no_instantiation_takes(width):
    with pytest.raises(ValueError):
        kernel.spmv_plan(width, F32, True)
    with pytest.raises(TypeError):
        kernel.spmv_plan(128, torch.float16, True)


def _walk(plan, nnz, width, predicated):
    """The kernel's loops in numpy: how many times each (row, element) is
    loaded (its value and column index, as part of a vector) and gathered
    (x at its column, added)."""
    rows = nnz.size
    per_warp = plan.rows * plan.unroll
    span = plan.lanes * plan.vec
    loads = np.zeros((rows, width), np.int64)
    gathers = np.zeros((rows, width), np.int64)
    for first in range(0, rows, per_warp):
        limit = {}
        for u in range(plan.unroll):
            for group in range(plan.rows):
                r = first + u * plan.rows + group
                if r >= rows:  # past the last row: nothing
                    limit[u, group] = 0
                else:
                    limit[u, group] = int(np.clip(nnz[r], 0, width)
                                          if predicated else width)
        most = max(limit.values())
        for base in range(0, most, span):
            for lane in range(32):
                group, sub = divmod(lane, plan.lanes)
                j = base + sub * plan.vec
                for u in range(plan.unroll):
                    r = first + u * plan.rows + group
                    if j < limit[u, group]:
                        assert j + plan.vec <= width  # inside the row
                        loads[r, j:j + plan.vec] += 1
                    for e in range(plan.vec):
                        if j + e < limit[u, group]:
                            gathers[r, j + e] += 1
    return loads, gathers


@pytest.mark.parametrize("width", EDGE_WIDTHS)
@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("aligned", [True, False])
def test_walk_visits_every_live_lane_once(width, dtype, aligned):
    rng = np.random.default_rng(width)
    rows = 45  # past one warp's rows, and not a multiple of them
    nnz = rng.integers(-3, width + 4, size=rows)
    nnz[:5] = [0, 1, -1, width, width + 9]
    for predicated in (True, False):
        plan = kernel.spmv_plan(width, dtype, predicated, aligned)
        loads, gathers = _walk(plan, nnz, width, predicated)
        live = np.clip(nnz, 0, width) if predicated else np.full(rows, width)
        lane = np.arange(width)
        np.testing.assert_array_equal(gathers, lane < live[:, None])
        assert loads.max() <= 1 and (loads >= gathers).all()
        if predicated:  # no vector wholly past row_nnz is loaded
            first_dead = -(-live // plan.vec) * plan.vec
            assert not loads[lane >= first_dead[:, None]].any()
        else:
            assert (loads == 1).all()


def _constants() -> dict:
    text = (CSRC / "spmv.cu").read_text()
    return {name: int(value) for name, value in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def test_plan_matches_the_cuda_source():
    got = _constants()
    assert got["kPredSpan"] == kernel.PRED_SPAN
    assert got["kFixedLanes"] == kernel.FIXED_LANES
    assert got["kUnroll"] == kernel.UNROLL
    assert got["kUnrollScalar"] == kernel.UNROLL_SCALAR
    text = (CSRC / "spmv.cu").read_text()
    # the fixed-width lane counts the source instantiates besides its max
    fixed = {int(n) for n in re.findall(r"!predicated && lanes == (\d+)",
                                        text)}
    lanes = {kernel.spmv_plan(w, dt, False).lanes
             for w in range(4, 520, 4) for dt in (F32, BF16)}
    assert lanes <= fixed | {kernel.FIXED_LANES}
    for dt in (F32, BF16):
        plan = kernel.spmv_plan(128, dt, True)
        assert plan.lanes * plan.vec == got["kPredSpan"]
        assert plan.rows * plan.unroll <= 32  # one coalesced row_nnz load


def _problem(width, dtype, seed, rows=24, n_cols=50):
    rng = np.random.default_rng(seed)
    nb, rb = rows // 8, 8
    vals = rng.standard_normal((nb, rb, width)).astype(np.float32)
    cols = rng.integers(0, n_cols, (nb, rb, width)).astype(np.int32)
    nnz = rng.integers(-2, width + 3, (nb, rb)).astype(np.int32)
    nnz[0, :5] = [0, -1, 1, width, width + 7]
    x = rng.standard_normal(n_cols).astype(np.float32)
    jv = jnp.asarray(vals, _JNP[dtype])
    jx = jnp.asarray(x, _JNP[dtype])
    tv = torch.from_numpy(np.array(jv.astype(jnp.float32))).to(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(dtype)
    return ((jv, jnp.asarray(cols), jnp.asarray(nnz), jx),
            (tv, torch.from_numpy(cols), torch.from_numpy(nnz), tx))


def _close(got, want, dtype):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    if dtype == F32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        m = np.abs(want).max()
        ulp = np.exp2(np.floor(np.log2(max(m, 1e-30))) - 7)
        assert np.all(np.abs(got - want) <= ulp), np.abs(got - want).max()


@pytest.mark.parametrize("width", EDGE_WIDTHS)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_plain_versions_match_reference_at_the_edges(width, dtype):
    jargs, targs = _problem(width, dtype, seed=width)
    _close(kernel.spmv_blockell(*targs), jspmv.spmv_blockell(*jargs), dtype)
    _close(kernel.spmv_fixed_width(*targs), jspmv.spmv_fixed_width(*jargs),
           dtype)
    torch.testing.assert_close(kernel.spmv_blockell_plain(*targs),
                               kernel.spmv_blockell(*targs), rtol=0, atol=0)


def test_probe_columns_are_the_sources_mix():
    rows, width, n = 5, 12, 1000
    i = np.arange(rows * width, dtype=np.uint64)
    m = np.uint64(0xFFFFFFFF)
    h = (i * np.uint64(0x9E3779B1)) & m
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & m
    h ^= h >> np.uint64(13)
    want = ((h * np.uint64(n)) >> np.uint64(32)).reshape(rows, width)
    got = ref.probe_columns(rows, width, n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert 0 <= got.min() and got.max() < n
    text = (CSRC / "spmv.cu").read_text()
    assert "0x9E3779B1u" in text and "0x85EBCA6Bu" in text


def test_gather_probe_sums_the_live_lanes():
    rng = np.random.default_rng(3)
    nnz = torch.from_numpy(rng.integers(-1, 20, (2, 8)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal(300).astype(np.float32))
    cols = ref.probe_columns(16, 16, 300).numpy()
    live = np.arange(16) < np.clip(nnz.numpy().reshape(16, 1), 0, 16)
    want = np.where(live, x.numpy()[cols], 0.0).sum(1)
    np.testing.assert_allclose(
        kernel.spmv_gather_probe(nnz, x, 16).numpy(), want, rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        kernel.spmv_gather_probe(nnz, x, 16, predicated=False).numpy(),
        x.numpy()[cols].sum(1), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="whole fp32 vectors"):
        kernel.spmv_gather_probe(nnz, x, 6)
