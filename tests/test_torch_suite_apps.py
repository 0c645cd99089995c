"""The port's 13-application suite (``repro_torch.suite.apps``) against the
reference's (``benchmarks/apps.py``).

* Every app's analytic fields (dtype, problem, full problem, kernels,
  flops, bytes, gather bytes, vectorizable fraction, notes) equal the
  reference's exactly.  SpMV's row lengths, the only draw its terms read,
  come from the port's threefry bit for bit.
* Each app's output equals the reference's on the reference's own inputs
  (taken from its closures, where its keys drew them, and passed to the
  port as numpy copies), within the tolerance :data:`TOL` states per app:
  exact where both sides do the same fp32 operations in the same order;
  the LLM bounds of ``tests/torch_train_checks.py``; relative bounds where
  the sums run in another order (FFTs, products, convolutions, AutoDock's
  sum over 1/d^12 terms); one bf16 ulp for SGEMM's bf16 output.
* At the paper's sizes (the card phase's) the analytic terms equal the
  reference's ``flops_bytes`` formulas, with no arrays built.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import benchmarks.apps as ref_apps  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.kernels.gemm import ref as ref_gemm  # noqa: E402
from repro.kernels.jacobi2d import ref as ref_jacobi  # noqa: E402
from repro.kernels.qc_gate import ref as ref_qc  # noqa: E402
from repro.kernels.spmv import ops as ref_spmv_ops  # noqa: E402
from repro.kernels.spmv import ref as ref_spmv  # noqa: E402
from repro.kernels.stream import ref as ref_stream  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.analysis import get_workload, list_workloads  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.suite import apps  # noqa: E402
from repro_torch.train import steps  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

FIELDS = ("name", "dtype", "problem", "full_problem", "kernels", "flops",
          "hbm_bytes", "gather_bytes", "vectorizable_fraction", "notes",
          "collective_bytes", "n_devices")

#: per app: (rtol, atol as a share of the reference output's largest
#: magnitude) of np.testing.assert_allclose
TOL = {
    "LLM-training": None,  # loss 1e-5 rel; grad norm and params 1e-4 / 1e-5
    "LLM-inference": (1e-4, 1e-5),
    "QC-simulator": (0.0, 0.0),  # the same fp32 products and sums
    "FFT1D": (1e-5, 4e-6),
    "FFT2D": (1e-5, 4e-6),
    "STREAM": (0.0, 0.0),
    "DGEMM": (1e-5, 4e-6),
    "SGEMM": (2.0 ** -8, 2.0 ** -8),  # one bf16 ulp, rounded either way
    "SpMV": (1e-5, 1e-6),
    "Jacobi2D": (0.0, 0.0),  # the same four sums and product, in order
    "YOLOv3": (1e-5, 4e-6),
    "AlexNet": (1e-5, 4e-6),
    "AutoDock": (1e-5, 0.0),
}


@pytest.fixture(scope="module")
def ref_suite():
    return ref_apps.suite()


@pytest.fixture(scope="module")
def port_suite():
    return apps.suite()


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) \
        if x.dtype == jnp.bfloat16 else np.asarray(x)


def _t(x):
    """A torch copy of a reference array (bf16 kept as bf16)."""
    bf16 = x.dtype == jnp.bfloat16
    t = torch.from_numpy(np.array(_np(x)))
    return t.to(torch.bfloat16) if bf16 else t


def _closure(fn):
    fn = getattr(fn, "__wrapped__", fn)  # a jitted function's Python body
    return inspect.getclosurevars(fn).nonlocals


def _ref_inputs(name, app):
    """The reference app's own inputs from its closures, as the port's
    arguments (NCHW images and OIHW weights for the CNNs)."""
    c = _closure(app.fn)
    if name == "LLM-training":
        cfg = port_configs.get_smoke_config("gpt2-124m")
        params = steps.params_from_numpy(
            jax.tree.map(np.asarray, c["params"]), cfg, "cpu")
        opt = adamw.init_opt_state(params, steps.RunConfig().opt)
        return params, opt, {k: _t(v) for k, v in c["batch"].items()}
    if name == "LLM-inference":
        cfg = port_configs.get_smoke_config("gpt2-124m")
        params = steps.params_from_numpy(
            jax.tree.map(np.asarray, c["params"]), cfg, "cpu")
        return params, _t(c["batch"]["tokens"])
    if name == "QC-simulator":
        return _t(c["re"]), _t(c["im"])
    if name in ("YOLOv3", "AlexNet"):
        weights = [_t(w).permute(3, 2, 0, 1).contiguous()
                   for w, _ in _closure(c["run"])["kernels"]]
        return _t(c["img"]).permute(0, 3, 1, 2).contiguous(), weights
    if name == "SpMV":
        return tuple(_t(c[k]) for k in ("vals", "cols", "nnz", "x"))
    order = {"FFT1D": ("x1",), "FFT2D": ("x2",), "STREAM": ("a", "b"),
             "DGEMM": ("x", "y"), "SGEMM": ("xb", "yb"), "Jacobi2D": ("u",),
             "AutoDock": ("lig", "rec", "q")}[name]
    return tuple(_t(c[k]) for k in order)


def _close(got, want, tol, what):
    rtol, share = tol
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=share * float(np.abs(want).max()),
                               err_msg=what)


# ---------------------------------------------------------------------------


def test_thirteen_apps_registered():
    assert apps.APP_NAMES == ref_apps.APP_NAMES
    names = list_workloads()
    assert [n for n in names if n.startswith("app/")] == sorted(
        f"app/{a}" for a in apps.APP_NAMES)
    assert list_workloads(tags=("app",)) == sorted(
        f"app/{a}" for a in apps.APP_NAMES)
    assert get_workload("app/STREAM") is apps.suite()["STREAM"]


@pytest.mark.parametrize("name", ref_apps.APP_NAMES)
def test_analytic_fields_equal_the_reference(name, ref_suite, port_suite):
    want, got = ref_suite[name], port_suite[name]
    assert isinstance(got, apps.App)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field
    assert got.ai == want.ai
    assert got.issue_model() == want.issue_model()


@pytest.mark.parametrize("n", [1024, 2048])
def test_spmv_row_nnz_is_the_references_bit_for_bit(n):
    _, _, want = ref_spmv.make_problem(jax.random.PRNGKey(0), n, n,
                                       row_block=8, max_nnz=64, width_pad=128)
    got = apps.spmv_row_nnz(n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals, cols, nnz, x = apps.spmv_problem(n)
    assert torch.equal(nnz, got) and tuple(x.shape) == (n,)
    lane = torch.arange(vals.shape[-1])
    assert not vals[lane >= nnz[..., None]].any()  # zero past each row
    assert int(cols.min()) >= 0 and int(cols.max()) < n


@pytest.mark.parametrize("name", ref_apps.APP_NAMES)
def test_output_equals_the_reference(name, ref_suite):
    ref_app = ref_suite[name]
    port_app = apps.suite()[name]
    want = jax.block_until_ready(ref_app.fn())
    got = port_app.fn(*_ref_inputs(name, ref_app))
    if name == "LLM-training":
        rparams, _, rmetrics = want
        params, _, metrics = got
        np.testing.assert_allclose(float(metrics["loss"]),
                                   float(rmetrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(rmetrics["grad_norm"]), rtol=1e-4)
        cfg = port_configs.get_smoke_config("gpt2-124m")
        rtree = steps.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                        cfg, "cpu")
        for g, w in zip(tree_leaves(params), tree_leaves(rtree)):
            np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                       rtol=1e-4, atol=1e-5)
        return
    if name == "QC-simulator":
        for g, w, part in zip(got, want, ("re", "im")):
            _close(g.numpy(), np.asarray(w), TOL[name], part)
        return
    if name in ("YOLOv3", "AlexNet"):
        got = got.permute(0, 2, 3, 1)  # NCHW -> the reference's NHWC
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.float().numpy(), _np(want), TOL[name], name)


def test_apps_draw_their_inputs_on_the_cpu_from_seeds(port_suite):
    """Each thunk draws the same inputs again (seeded generators), on the
    CPU, and ``args_on`` moves the nested LLM arguments as a tree."""
    for name in ("FFT1D", "SpMV", "YOLOv3", "AutoDock"):
        first = port_suite[name].args()
        again = port_suite[name].args()
        for a, b in zip(tree_leaves(list(first)), tree_leaves(list(again))):
            assert a.device.type == "cpu" and torch.equal(a, b)
    app = port_suite["LLM-training"]
    params, opt, batch = app.args_on(torch.device("cpu"))
    assert set(batch) == {"tokens", "labels"}
    assert set(opt) >= {"step", "m", "v"}
    assert app.args_on(torch.device("cpu"))[0] is params


# -- the paper's sizes (the card phase builds these) ------------------------


def test_full_size_terms_equal_the_reference_formulas():
    qc = apps._qc_app(21)
    fb = ref_qc.flops_bytes(21)
    assert qc.flops == fb["flops"] * 21
    assert qc.hbm_bytes == fb["bytes"] * 21 * 0.3125
    assert qc.problem == "21 qubits"

    st = apps._stream_app(1024)
    fb = ref_stream.flops_bytes("triad", 2**21 * 128, 4)
    assert (st.flops, st.hbm_bytes, st.problem) == (fb["flops"], fb["bytes"],
                                                    "1024MB")

    dgemm, sgemm = apps._gemm_apps(12288)
    assert dgemm.flops == ref_gemm.flops_bytes(12288, 12288, 12288, 4)["flops"]
    assert dgemm.hbm_bytes == ref_gemm.flops_bytes(12288, 12288, 12288,
                                                   4)["bytes"]
    assert sgemm.hbm_bytes == ref_gemm.flops_bytes(12288, 12288, 12288,
                                                   2)["bytes"]

    jac = apps._jacobi_app(16384)
    fb = ref_jacobi.flops_bytes(16384, 16384, 4)
    assert (jac.flops, jac.hbm_bytes) == (fb["flops"], fb["bytes"])

    yolo = apps._yolo_app(608)
    want = ref_apps._conv_stack(
        jax.random.PRNGKey(1), [(32, 3, 1), (64, 3, 2), (128, 3, 2),
                                (256, 3, 2)],
        jax.ShapeDtypeStruct((1, 608, 608, 3), jnp.float32), "YOLOv3",
        "608^2 x 3")
    for field in FIELDS:
        assert getattr(yolo, field) == getattr(want, field), field

    cfg = port_configs.get_config("gpt2-124m")
    train, infer = apps._llm_apps(cfg)
    n, T = ref_get_config("gpt2-124m").param_count(), 64 * 4
    assert cfg.param_count() == n
    assert train.flops == 6.0 * n * T
    assert train.hbm_bytes == 34.0 * n * 2 + 10 * T * cfg.d_model * 4
    assert infer.flops == 2.0 * n * T
    assert infer.hbm_bytes == 2.0 * n * 2 + 6 * T * cfg.d_model * 4
    assert train.problem == f"{n/1e6:.1f}M@{T}tok"
    # nothing was drawn: every builder keeps its inputs behind the thunk
    for app in (qc, st, dgemm, sgemm, jac, yolo, train, infer):
        assert app._resolved_args is None


def test_spmv_terms_come_from_the_drawn_row_lengths():
    nnz = apps.spmv_row_nnz(2048).numpy()
    fb = ref_spmv_ops.flops_bytes(nnz, repeat=1, dtype_bytes=4)
    app = apps._spmv_app()
    assert (app.flops, app.hbm_bytes, app.gather_bytes) == (
        fb["flops"], fb["bytes"], fb["gather_bytes"])


def test_same_pads_match_xla():
    for h, k, s in ((128, 3, 1), (128, 3, 2), (224, 11, 4), (56, 5, 1),
                    (608, 3, 2), (7, 3, 2), (5, 4, 3)):
        lo, hi = apps.same_pads(h, k, s)
        x = jnp.ones((1, h, h, 1))
        w = jnp.ones((k, k, 1, 1))
        same = jax.lax.conv_general_dilated(
            x, w, (s, s), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
        explicit = jax.lax.conv_general_dilated(
            x, w, (s, s), [(lo, hi), (lo, hi)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        np.testing.assert_array_equal(np.asarray(same), np.asarray(explicit))
