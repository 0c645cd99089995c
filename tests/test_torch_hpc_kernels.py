"""The port's HPC kernels (GEMM, STREAM, Jacobi2D, block-ELL SpMV) against
the reference's.

On the CPU each registered op runs its plain version, which is held
against the JAX op in interpret mode (the reference registry's default
``op(*args)``), and each port oracle against the JAX ``ref.py``, on the
same numpy inputs.  The CUDA kernels run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances, in the arrays' dtype:
- STREAM and Jacobi2D: bit-equal, except the triad against the Pallas
  interpret path in fp32 and fp16, which XLA's CPU backend computes without
  rounding q*b (an FMA in fp32) where the oracle, the port and the CUDA
  kernel round it: there, 1 ulp of |q*b| plus 1 ulp of the result.
- GEMM: fp32 1e-5 * max|ref|; bf16 1 bf16 ulp of the result + 1e-5 *
  max|ref| (fp32 sums in another order, then one rounding).
- SpMV: fp32 rtol 1e-5, atol 1e-6 (row sums in another order); bf16 one
  bf16 ulp of max|y|, because the reference rounds its row sums and repeat
  steps to bf16 where the port rounds once at the end, so its error scales
  with the largest sums (its own interpret test holds bf16 at 5e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import registry as jreg  # noqa: E402
from repro.kernels.gemm import ref as jgemm_ref  # noqa: E402
from repro.kernels.jacobi2d import ref as jjac_ref  # noqa: E402
from repro.kernels.spmv import ops as jspmv_ops, ref as jspmv_ref  # noqa: E402
from repro.kernels.stream import ops as jstream_ops, ref as jstream_ref  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.gemm import kernel as gemm_k, ref as gemm_r  # noqa: E402
from repro_torch.kernels.jacobi2d import ops as jac_ops, ref as jac_r  # noqa: E402
from repro_torch.kernels.spmv import ops as spmv_ops, ref as spmv_r  # noqa: E402
from repro_torch.kernels.stream import ops as stream_ops, ref as stream_r  # noqa: E402

torch.set_num_threads(2)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
        "float16": jnp.float16}
_MANTISSA = {"float32": 23, "bfloat16": 7, "float16": 10}


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(arr, _JNP[dtype])
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ulp(x: np.ndarray, dtype: str) -> np.ndarray:
    """Spacing of ``dtype`` numbers at |x| (normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 1e-30)))
    return np.exp2(e - _MANTISSA[dtype])


# ---------------------------------------------------------------------------
# GEMM
# ---------------------------------------------------------------------------

GEMM_CASES = [
    # M, N, K, bm, bn, bk, dtype (tests/test_kernels.py GEMM_CASES)
    (32, 32, 32, 32, 32, 32, "float32"),
    (64, 32, 96, 32, 16, 24, "float32"),
    (128, 128, 64, 64, 64, 32, "float32"),
    (48, 80, 56, 16, 16, 8, "float32"),
    (64, 64, 64, 32, 32, 32, "bfloat16"),
    (64, 64, 128, 64, 64, 128, "bfloat16"),  # single k step
]


def _gemm_close(got, want, dtype):
    got, want = _np(got), _np(want)
    tol = 1e-5 * np.abs(want).max()
    if dtype == "bfloat16":
        tol = tol + _ulp(want, dtype)
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("M,N,K,bm,bn,bk,dtype", GEMM_CASES)
def test_gemm_plain_and_oracle_match_reference(M, N, K, bm, bn, bk, dtype):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng.standard_normal((M, K)), dtype)
    jy, ty = _pair(rng.standard_normal((K, N)), dtype)
    got = registry.GEMM(tx, ty, bm=bm, bn=bn, bk=bk)
    assert got.dtype == tx.dtype and tuple(got.shape) == (M, N)
    _gemm_close(got, jreg.GEMM(jx, jy, bm=bm, bn=bn, bk=bk), dtype)
    _gemm_close(registry.GEMM.ref(tx, ty), jgemm_ref.gemm_ref(jx, jy), dtype)
    torch.testing.assert_close(
        registry.GEMM.interpret(tx, ty, bm=bm, bn=bn, bk=bk), got,
        rtol=0, atol=0)


def test_gemm_tiling_is_invisible():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    outs = [registry.GEMM(x, y, bm=bm, bn=bn, bk=bk)
            for bm, bn, bk in [(64, 64, 64), (32, 32, 16), (16, 64, 32)]]
    for o in outs[1:]:
        torch.testing.assert_close(outs[0], o, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape_x,shape_y,tiles", [
    ((64, 32), (32, 48), dict(bm=48)),       # 64 % 48
    ((64, 32), (32, 48), dict(bk=24)),       # 32 % 24
    ((100, 32), (32, 32), {}),               # 100 % min(128, 100) is fine
])
def test_gemm_tile_checks_fail_where_the_reference_fails(shape_x, shape_y,
                                                         tiles):
    jx, jy = jnp.ones(shape_x), jnp.ones(shape_y)
    tx, ty = torch.ones(shape_x), torch.ones(shape_y)
    try:
        jreg.GEMM(jx, jy, **tiles)
        ref_fails = False
    except AssertionError:
        ref_fails = True
    if ref_fails:
        with pytest.raises(ValueError, match="not divisible"):
            registry.GEMM(tx, ty, **tiles)
        with pytest.raises(ValueError, match="not divisible"):
            registry.GEMM.interpret(tx, ty, **tiles)
    else:
        assert tuple(registry.GEMM(tx, ty, **tiles).shape) == (
            shape_x[0], shape_y[1])


def test_gemm_flops_bytes_equal_reference():
    for args in [(128, 128, 128), (4096, 4096, 4096, 2), (8192, 8192, 8192)]:
        assert gemm_r.flops_bytes(*args) == jgemm_ref.flops_bytes(*args)


# ---------------------------------------------------------------------------
# STREAM
# ---------------------------------------------------------------------------


def _triad_tol(want, b, q, dtype):
    qb = np.float64(q) * _np(b)
    return _ulp(qb, dtype) + _ulp(_np(want), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("rows,br", [(64, 16), (64, 64), (256, 32)])
@pytest.mark.parametrize("q", [2.5, 0.3])
def test_stream_plain_and_oracle_match_reference(dtype, rows, br, q):
    rng = np.random.default_rng(0)
    ja, ta = _pair(rng.standard_normal((rows, 128)), dtype)
    jb, tb = _pair(rng.standard_normal((rows, 128)), dtype)
    cases = [
        ("copy", (ja,), (ta,), jreg.STREAM_COPY, registry.STREAM_COPY),
        ("scale", (ja, q), (ta, q), jreg.STREAM_SCALE, registry.STREAM_SCALE),
        ("add", (ja, jb), (ta, tb), jreg.STREAM_ADD, registry.STREAM_ADD),
        ("triad", (ja, jb, q), (ta, tb, q), jreg.STREAM_TRIAD,
         registry.STREAM_TRIAD),
    ]
    for name, jargs, targs, jop, top in cases:
        got = top(*targs, block_rows=br)
        assert got.dtype == ta.dtype, name
        # the oracles, and the port against the oracle: bit for bit
        np.testing.assert_array_equal(_np(top.ref(*targs)),
                                      _np(jop.ref(*jargs)), err_msg=name)
        np.testing.assert_array_equal(_np(got), _np(jop.ref(*jargs)),
                                      err_msg=name)
        np.testing.assert_array_equal(
            _np(top.interpret(*targs, block_rows=br)), _np(got), err_msg=name)
        pallas = _np(jop(*jargs, block_rows=br))
        if name == "triad" and dtype != "bfloat16":
            tol = _triad_tol(pallas, tb, q, dtype)
            assert np.all(np.abs(_np(got) - pallas) <= tol), name
        else:
            np.testing.assert_array_equal(_np(got), pallas, err_msg=name)


def test_stream_block_rows_must_divide_rows():
    a = torch.ones((96, 128))
    with pytest.raises(ValueError, match="not divisible"):
        registry.STREAM_COPY(a, block_rows=64)
    with pytest.raises(ValueError, match="not divisible"):
        registry.STREAM_TRIAD.interpret(a, a, 3.0, block_rows=64)
    with pytest.raises(AssertionError):
        jreg.STREAM_COPY(jnp.ones((96, 128)), block_rows=64)


def test_stream_issue_model_and_flops_bytes_equal_reference():
    for n in (1 << 20, 1000, 7):
        for elen in (64, 32, 16, 8):
            assert stream_ops.issue_counts(n, elen) == \
                jstream_ops.issue_counts(n, elen)
    for kind in ("copy", "scale", "add", "triad"):
        for n, b in [(1 << 28, 4), (4096, 2)]:
            assert stream_r.flops_bytes(kind, n, b) == \
                jstream_ref.flops_bytes(kind, n, b)


# ---------------------------------------------------------------------------
# Jacobi2D
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H,W,br", [(32, 128, 8), (32, 128, 32), (64, 256, 16),
                                    (16, 128, 4)])
def test_jacobi_plain_and_oracle_match_reference(H, W, br):
    rng = np.random.default_rng(2)
    ju, tu = _pair(rng.standard_normal((H, W)), "float32")
    got = registry.JACOBI_STEP(tu, block_rows=br)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jreg.JACOBI_STEP(ju, block_rows=br)))
    np.testing.assert_array_equal(registry.JACOBI_STEP.ref(tu).numpy(),
                                  np.asarray(jjac_ref.jacobi_ref(ju)))
    np.testing.assert_array_equal(
        registry.JACOBI_STEP.interpret(tu, block_rows=br).numpy(),
        got.numpy())


@pytest.mark.parametrize("H,W", [(1, 5), (2, 7), (7, 2), (3, 3), (33, 130)])
def test_jacobi_any_size_matches_reference_oracle(H, W):
    """Sizes no CUDA tile divides, and grids that are all boundary."""
    rng = np.random.default_rng(H * 100 + W)
    ju, tu = _pair(rng.standard_normal((H, W)), "float32")
    got = registry.JACOBI_STEP(tu, block_rows=H)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jjac_ref.jacobi_ref(ju)))


def test_jacobi_boundary_passthrough():
    u = torch.from_numpy(
        np.random.default_rng(3).standard_normal((16, 128)).astype(np.float32))
    out = registry.JACOBI_STEP(u, block_rows=8)
    for edge in (lambda t: t[0], lambda t: t[-1], lambda t: t[:, 0],
                 lambda t: t[:, -1]):
        torch.testing.assert_close(edge(out), edge(u), rtol=0, atol=0)


def test_jacobi_bf16_plain_rounds_the_fp32_sweep_once():
    u = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (32, 64)).astype(np.float32)).to(torch.bfloat16)
    got = registry.JACOBI_STEP(u, block_rows=32)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, jac_r.jacobi_plain(u.float()).to(
        torch.bfloat16), rtol=0, atol=0)


def test_jacobi_multi_sweep_matches_reference_driver():
    from repro.kernels.jacobi2d import ops as jjac_ops

    u = np.zeros((16, 128), np.float32)
    u[8, 64] = 100.0
    got = jac_ops.jacobi(torch.from_numpy(u), sweeps=50, block_rows=8)
    want = jjac_ops.jacobi(jnp.asarray(u), sweeps=50, block_rows=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_jacobi_flops_bytes_equal_reference():
    for args in [(256, 256, 4), (16384, 16384, 4), (4096, 4096, 8)]:
        assert jac_r.flops_bytes(*args) == jjac_ref.flops_bytes(*args)


# ---------------------------------------------------------------------------
# SpMV
# ---------------------------------------------------------------------------

SWEEP = [
    # n_rows, n_cols, row_block, max_nnz, width_pad, dtype
    (16, 64, 8, 32, 32, "float32"),
    (32, 128, 8, 64, 64, "float32"),
    (64, 256, 8, 128, 128, "float32"),
    (16, 64, 8, 17, 32, "float32"),     # ragged, non-multiple nnz
    (8, 32, 8, 8, 32, "float32"),
    (16, 64, 8, 32, 32, "bfloat16"),
]


def _spmv_problem(n_rows, n_cols, rb, max_nnz, wp, dtype, seed=0):
    """The reference's problem (jax.random), as numpy, then as JAX and
    torch arrays of ``dtype``."""
    vals, cols, nnz = jspmv_ref.make_problem(
        jax.random.PRNGKey(seed), n_rows, n_cols, row_block=rb,
        max_nnz=max_nnz, width_pad=wp)
    x = np.random.default_rng(seed + 1).standard_normal(n_cols)
    jv, tv = _pair(np.asarray(vals), dtype)
    jx, tx = _pair(x, dtype)
    jc, jn = jnp.asarray(cols), jnp.asarray(nnz)
    tc = torch.from_numpy(np.asarray(cols).astype(np.int32))
    tn = torch.from_numpy(np.asarray(nnz).astype(np.int32))
    return (jv, jc, jn, jx), (tv, tc, tn, tx)


def _spmv_close(got, want, dtype):
    got, want = _np(got), _np(want)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        tol = _ulp(np.abs(want).max(), dtype)
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.mark.parametrize("n_rows,n_cols,rb,max_nnz,wp,dtype", SWEEP)
def test_spmv_plain_and_oracle_match_reference(n_rows, n_cols, rb, max_nnz,
                                               wp, dtype):
    jargs, targs = _spmv_problem(n_rows, n_cols, rb, max_nnz, wp, dtype)
    got = registry.SPMV(*targs)
    assert got.dtype == targs[0].dtype and tuple(got.shape) == (n_rows,)
    _spmv_close(got, jreg.SPMV(*jargs), dtype)
    _spmv_close(registry.SPMV.ref(*targs), jspmv_ref.spmv_ref(*jargs), dtype)
    torch.testing.assert_close(registry.SPMV.interpret(*targs), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("repeat", [1, 4, 20])
def test_spmv_repeat_matches_reference(repeat):
    jargs, targs = _spmv_problem(16, 64, 8, 32, 32, "float32", seed=4)
    got = registry.SPMV(*targs, repeat=repeat)
    _spmv_close(got, jreg.SPMV(*jargs, repeat=repeat), "float32")
    _spmv_close(registry.SPMV.ref(*targs, repeat=repeat),
                jspmv_ref.spmv_ref(*jargs, repeat=repeat), "float32")
    # the intensity knob does not change the answer
    torch.testing.assert_close(got, registry.SPMV(*targs), rtol=1e-4,
                               atol=1e-5)


def test_spmv_fixed_width_equals_predicated():
    jargs, targs = _spmv_problem(16, 64, 8, 32, 32, "float32", seed=6)
    yf = registry.SPMV_FIXED(*targs)
    torch.testing.assert_close(yf, registry.SPMV(*targs), rtol=1e-5,
                               atol=1e-6)
    _spmv_close(yf, jreg.SPMV_FIXED(*jargs), "float32")
    torch.testing.assert_close(registry.SPMV_FIXED.interpret(*targs), yf,
                               rtol=0, atol=0)


def test_spmv_matches_dense_matmul():
    _, targs = _spmv_problem(24, 48, 8, 16, 16, "float32", seed=2)
    vals, cols, nnz, x = targs
    a = spmv_r.dense_from_blockell(vals, cols, nnz, 48)
    np.testing.assert_allclose(registry.SPMV(*targs).numpy(),
                               a @ x.double().numpy(), rtol=1e-4, atol=1e-4)


def test_spmv_predicate_ignores_lanes_past_row_nnz():
    """Lanes at or past row_nnz never count, whatever they hold."""
    _, (vals, cols, nnz, x) = _spmv_problem(16, 64, 8, 17, 32, "float32",
                                            seed=8)
    lane = torch.arange(vals.shape[-1])
    poisoned = torch.where(lane < nnz[..., None], vals,
                           torch.tensor(float("nan")))
    torch.testing.assert_close(registry.SPMV(poisoned, cols, nnz, x),
                               registry.SPMV(vals, cols, nnz, x),
                               rtol=0, atol=0)


def test_spmv_make_problem_follows_the_reference_law():
    g = torch.Generator().manual_seed(0)
    vals, cols, nnz = spmv_r.make_problem(100, 300, row_block=8, max_nnz=17,
                                          width_pad=32, generator=g)
    assert tuple(vals.shape) == (13, 8, 32) and vals.dtype == torch.float32
    assert cols.dtype == torch.int32 and nnz.dtype == torch.int32
    assert tuple(nnz.shape) == (13, 8)
    assert int(nnz.min()) >= 1 and int(nnz.max()) <= 17
    assert int(cols.min()) >= 0 and int(cols.max()) < 300
    lane = torch.arange(32)
    assert not vals[lane >= nnz[..., None]].any()
    again = spmv_r.make_problem(100, 300, row_block=8, max_nnz=17,
                                width_pad=32,
                                generator=torch.Generator().manual_seed(0))
    for a, b in zip((vals, cols, nnz), again):
        assert torch.equal(a, b)
    jv, _, _ = jspmv_ref.make_problem(jax.random.PRNGKey(0), 100, 300,
                                      row_block=8, max_nnz=17, width_pad=32)
    assert tuple(jv.shape) == tuple(vals.shape)


def test_spmv_issue_counts_and_flops_bytes_equal_reference():
    nnz = np.random.default_rng(0).integers(0, 129, size=(64, 8)).astype(
        np.int32)
    for width, lane in [(128, 128), (128, 32), (256, 16)]:
        assert spmv_ops.issue_counts(torch.from_numpy(nnz), width, lane) == \
            jspmv_ops.issue_counts(nnz, width, lane)
    for repeat, b in [(1, 4), (20, 4), (1, 2)]:
        assert spmv_ops.flops_bytes(torch.from_numpy(nnz), repeat, b) == \
            jspmv_ops.flops_bytes(nnz, repeat, b)


# ---------------------------------------------------------------------------
# the registry's call surfaces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,args", [
    ("gemm", lambda: (torch.ones(8, 8), torch.ones(8, 8))),
    ("stream-triad", lambda: (torch.ones(8, 128), torch.ones(8, 128), 3.0)),
    ("stream-copy", lambda: (torch.ones(8, 128),)),
    ("jacobi2d", lambda: (torch.ones(8, 8),)),
    ("spmv", lambda: (torch.ones(1, 8, 32), torch.zeros(1, 8, 32,
                                                        dtype=torch.int32),
                      torch.ones(1, 8, dtype=torch.int32), torch.ones(4))),
    ("spmv-fixed-width", lambda: (torch.ones(1, 8, 32),
                                  torch.zeros(1, 8, 32, dtype=torch.int32),
                                  torch.ones(1, 8, dtype=torch.int32),
                                  torch.ones(4))),
])
def test_kernel_surface_raises_on_cpu_tensors(name, args):
    ops = registry.get_kernel(name)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.kernel(*args())
    # the default call takes CPU tensors to the plain version
    torch.testing.assert_close(ops(*args()), ops.interpret(*args()),
                               rtol=0, atol=0)


def test_registry_lists_the_ported_kernels():
    assert registry.list_kernels() == sorted([
        "gemm", "stream-copy", "stream-scale", "stream-add", "stream-triad",
        "spmv", "spmv-fixed-width", "jacobi2d"])
    for name in registry.list_kernels():
        assert name in jreg.KERNELS
    with pytest.raises(KeyError, match="unknown kernel"):
        registry.get_kernel("qc-gate")


def test_plain_versions_do_not_launch_kernels():
    from repro_torch.kernels.gemm import kernel as gk
    from repro_torch.kernels.spmv import kernel as sk

    before = (gk.gemm.launches, sk.spmv_blockell.launches)
    registry.GEMM(torch.ones(8, 8), torch.ones(8, 8))
    _, targs = _spmv_problem(8, 32, 8, 8, 32, "float32")
    registry.SPMV(*targs)
    assert (gk.gemm.launches, sk.spmv_blockell.launches) == before
    assert gemm_k.gemm.launches == before[0]
