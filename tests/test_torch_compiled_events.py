"""The port's compiled event source (``core/op_cost.py`` and
``counters.events_from_compiled`` over a recording of the aten operators
one CPU run dispatches) against the reference's (``core/hlo_cost.py`` and
``core/counters.py`` over XLA's compiled HLO).

* The cost walk and the counters mirror ``tests/test_hlo_cost.py`` and
  ``tests/test_counters.py``.  Both packages get the same inputs: seeded
  numpy arrays, or their ``ShapeDtypeStruct`` for the reference's compile.
* The five ``vectorization_report`` workloads: the same Fig. 8 class on
  the four reference chips, and ``mxu_flops``, ``gather_bytes`` and
  ``nonvec_flops`` equal to the reference's within rel 1e-6.  ``flops``
  and ``bytes_accessed`` are pinned to the port's own values, not to
  XLA's: XLA fuses and eager PyTorch does not, so every unfused
  intermediate is counted (1 flop an output element, operands plus
  outputs of traffic).
* The registry's seven kernel workloads, ``source="compiled"``: each
  one's ``mxu_flops`` equal to the reference's compiled count (rel 1e-9).
  The reference's compile counts its interpret-mode Pallas grid's
  bookkeeping, so its flops, bytes and classes are not held; the port's
  are pinned.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.analysis import ArtifactCache as RefCache  # noqa: E402
from repro.analysis import Workload as RefWorkload  # noqa: E402
from repro.analysis import analyze_sweep as ref_analyze_sweep  # noqa: E402
from repro.core import counters as ref_counters  # noqa: E402
from repro.core import hlo_cost as ref_hlo_cost  # noqa: E402
from repro.core import hw as ref_hw  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    ArtifactCache, Workload, analyze, analyze_compiled, analyze_sweep,
    list_workloads,
)
from repro_torch.core import counters, hw, op_cost  # noqa: E402
from repro_torch.core.op_cost import Op, Recording, TensorMeta  # noqa: E402
from repro_torch.examples import vectorization_report  # noqa: E402

REF_CHIPS = ("grace-core", "grace-socket", "tpu-v5e", "tpu-v5p")
N, K = 128, 8


def _randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


def _ref_compile(fn, *shapes):
    specs = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return jax.jit(fn).lower(*specs).compile()


# ---------------------------------------------------------------------------
# Synthetic recordings: collectives by kind
# ---------------------------------------------------------------------------

F32, BF16 = torch.float32, torch.bfloat16
ROW = TensorMeta((128, 256), F32)

#: the ops of ``tests/test_counters.py``'s SYNTHETIC_HLO, as the port
#: records them: one of each collective kind, an all-gather twice (the
#: reference's sync and async-start), and a product that is no collective
SYNTHETIC_HLO = """
ENTRY %main {
  %p0 = f32[128,256]{1,0} parameter(0)
  %p1 = bf16[64,64]{1,0} parameter(1)
  %ag = f32[512,256]{1,0} all-gather(f32[128,256]{1,0} %p0), replica_groups={}, dimensions={0}
  %ar = bf16[64,64]{1,0} all-reduce(bf16[64,64]{1,0} %p1), to_apply=%add
  %rs = f32[32,256]{1,0} reduce-scatter(f32[128,256]{1,0} %p0), dimensions={0}
  %a2a = f32[128,256]{1,0} all-to-all(f32[128,256]{1,0} %p0), dimensions={0}
  %cp = f32[128,256]{1,0} collective-permute(f32[128,256]{1,0} %p0), source_target_pairs={{0,1}}
  %ags = (f32[128,256]{1,0}, f32[512,256]{1,0}) all-gather-start(f32[128,256]{1,0} %p0), dimensions={0}
  %dot = f32[128,64]{1,0} dot(f32[128,256]{1,0} %p0, f32[256,64]{1,0} %w), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}
"""
SYNTHETIC = Recording(ops=(
    Op("_c10d_functional", "all_gather_into_tensor", "default",
       (ROW, 4, "g"), {}, TensorMeta((512, 256), F32)),
    Op("_c10d_functional", "all_reduce", "default",
       (TensorMeta((64, 64), BF16), "sum", "g"), {},
       TensorMeta((64, 64), BF16)),
    Op("_c10d_functional", "reduce_scatter_tensor", "default",
       (ROW, "sum", 4, "g"), {}, TensorMeta((32, 256), F32)),
    Op("_c10d_functional", "all_to_all_single", "default",
       (ROW, [32] * 4, [32] * 4, "g"), {}, ROW),
    Op("c10d", "send", "default", ([ROW], "ProcessGroup", 1, 0), {}, "Work"),
    Op("c10d", "allgather_", "default",
       ([[ROW] * 4], [ROW], "ProcessGroup", False, -1), {},
       ([[ROW] * 4], "Work")),
    Op("aten", "mm", "default", (ROW, TensorMeta((256, 64), F32)), {},
       TensorMeta((128, 64), F32)),
))


def test_synthetic_recording_collectives_by_kind_equal_reference():
    got = counters.parse_collectives(SYNTHETIC)
    want = ref_counters.parse_collectives(SYNTHETIC_HLO)
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert got.count_by_kind["all-gather"] == 2 and got.total_count == 6
    cost = op_cost.cost_of_recording(SYNTHETIC)
    assert cost.collective_bytes_by_kind == want.bytes_by_kind
    assert cost.collective_bytes == want.total_bytes
    assert cost.mxu_flops == ref_counters.parse_mxu_flops(SYNTHETIC_HLO)


def test_recorded_gloo_collectives_by_kind(tmp_path):
    """The port's mesh issues ``dist.all_reduce`` and ``dist.all_gather``
    (``distributed/collectives.py``): recorded as the in-place ``c10d``
    ops, their input bytes counted under the reference's kinds."""
    import torch.distributed as dist

    def f(x):
        dist.all_reduce(x)
        parts = [torch.empty_like(x)]
        dist.all_gather(parts, x)
        return parts[0]

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        rec = op_cost.record(f, (torch.ones((64, 64)),))
    finally:
        dist.destroy_process_group()
    stats = counters.parse_collectives(rec)
    assert stats.bytes_by_kind == {"all-reduce": 64 * 64 * 4,
                                   "all-gather": 64 * 64 * 4}
    assert stats.count_by_kind == {"all-reduce": 1, "all-gather": 1}


def test_broadcast_and_non_collectives():
    bcast = Recording(ops=(
        Op("c10d", "broadcast_", "default",
           ([ROW], "ProcessGroup", 0, 0, False, -1), {}, ([ROW], "Work")),
        Op("aten", "add", "Tensor", (ROW, ROW), {}, ROW)))
    stats = counters.parse_collectives(bcast)
    assert stats.bytes_by_kind == {"collective-broadcast": 128 * 256 * 4}
    assert stats.total_count == 1
    ev = counters.events_from_compiled(bcast, n_devices=2)
    assert ev.collective_bytes == 2 * 128 * 256 * 4
    assert ev.collectives.count_by_kind == {"collective-broadcast": 1}
    assert ev.census["collective-broadcast"] == 2


# ---------------------------------------------------------------------------
# Recorded programs
# ---------------------------------------------------------------------------


def test_events_from_a_recorded_program_match_reference_products():
    """``tanh(a @ b).sum()``: the product equal to the reference's
    structural count (rel 1e-9), the operands' bytes at least, no
    collectives, a dot in the census."""

    def f(a, b):
        return torch.tanh(a @ b).sum()

    a, b = _randn(0, (256, 512)), _randn(1, (512, 128))
    rec = op_cost.record(f, (torch.from_numpy(a), torch.from_numpy(b)))
    ev = counters.events_from_compiled(rec, n_devices=1)
    want = ref_counters.events_from_compiled(
        _ref_compile(lambda x, y: jnp.tanh(x @ y).sum(), a.shape, b.shape),
        n_devices=1)
    assert ev.mxu_flops == pytest.approx(want.mxu_flops, rel=1e-9)
    assert ev.mxu_flops == 2 * 256 * 512 * 128
    assert ev.flops >= ev.mxu_flops
    assert ev.bytes_accessed >= (256 * 512 + 512 * 128) * 4
    assert ev.collective_bytes == 0 and ev.collectives.total_count == 0
    assert ev.census["dot"] >= 1
    assert ev.xla_raw_flops == ev.mxu_flops  # FlopCounterMode: mm only
    assert ev.argument_bytes_per_device == (256 * 512 + 512 * 128) * 4
    assert ev.output_bytes_per_device == 4
    assert ev.temp_bytes_per_device >= 256 * 128 * 4


def test_events_global_normalization():
    """Events are global: x n_devices, census included."""
    rec = op_cost.record(lambda a: a * 2.0, (torch.ones(1024),))
    ev1 = counters.events_from_compiled(rec, n_devices=1)
    ev4 = counters.events_from_compiled(rec, n_devices=4)
    assert ev1.bytes_accessed > 0
    assert ev4.bytes_accessed == pytest.approx(4 * ev1.bytes_accessed)
    assert ev4.flops == pytest.approx(4 * ev1.flops)
    assert ev4.hbm_read_bytes == pytest.approx(0.5 * ev4.bytes_accessed)
    assert ev4.census == {k: 4 * v for k, v in ev1.census.items()}
    assert ev4.n_devices == 4


def _loop(x):
    for _ in range(K):
        x = x @ x
    return x


def _nested(x):
    for _ in range(3):
        for _ in range(4):
            x = x @ x
    return x


def test_eager_loops_count_every_iteration():
    """The reference's structural walk scales the scanned body by its trip
    count (K·2N³, exact); an eager loop records every iteration, and so
    does FlopCounterMode.  Nothing is a trip count."""
    x = torch.from_numpy(_randn(2, (N, N)) * 0.01)
    ev = counters.events_from_compiled(op_cost.record(_loop, (x,)))

    def scanned(c):
        def body(c, _):
            return c @ c, None
        return jax.lax.scan(body, c, None, length=K)[0]

    ref = ref_hlo_cost.cost_of_module(_ref_compile(scanned, (N, N)).as_text())
    assert ev.mxu_flops == ref.mxu_flops == K * 2 * N**3
    assert ev.xla_raw_flops == K * 2 * N**3
    assert ev.while_trip_counts == [] and ev.unknown_trip_counts == 0
    assert ev.census["dot"] == K
    nested = counters.events_from_compiled(op_cost.record(_nested, (x,)))
    assert nested.mxu_flops == 12 * 2 * N**3


def test_in_place_products_use_the_out_of_place_formula():
    """``addmm_`` has no entry in ``flop_registry``: the walk charges it as
    ``addmm`` (the plain GEMM accumulates in place), FlopCounterMode does
    not count it."""

    def acc_gemm(x, y):
        acc = torch.zeros((N, N))
        for k0 in range(0, N, 32):
            acc.addmm_(x[:, k0:k0 + 32], y[k0:k0 + 32])
        return acc

    x = torch.from_numpy(_randn(3, (N, N)))
    ev = counters.events_from_compiled(op_cost.record(acc_gemm, (x, x)))
    assert ev.mxu_flops == 2 * N**3
    assert ev.xla_raw_flops == 0.0


def test_in_place_update_charges_slice_not_buffer():
    def update(cache, new):
        cache[:, 5:6] = new
        return cache

    cache, new = torch.zeros((1024, 1024)), torch.ones((1024, 1))
    rec = op_cost.record(update, (cache, new))
    cost = op_cost.cost_of_recording(rec)
    assert cost.traffic_bytes < 0.1 * 1024 * 1024 * 4
    assert cost.traffic_bytes == 2 * 1024 * 4
    assert cache.sum() == 0  # the run worked on a copy


def test_elementwise_estimate():
    a = torch.from_numpy(_randn(4, (4096,)))
    cost = op_cost.cost_of_recording(
        op_cost.record(lambda a, b: torch.tanh(a) * b + 1.0, (a, a)))
    assert cost.mxu_flops == 0.0
    assert cost.vpu_flop_estimate >= 4096
    assert cost.traffic_bytes >= 3 * 4096 * 4


def test_gathers_scatters_and_nonvec_ops():
    x = torch.from_numpy(_randn(5, (4096,)))
    idx = torch.from_numpy(np.random.default_rng(6).integers(0, 4096, 1024))
    gather = op_cost.cost_of_recording(
        op_cost.record(lambda x, i: x[i], (x, idx)))
    assert gather.gather_bytes == 1024 * 4
    assert gather.traffic_bytes == 2 * 1024 * 4

    def scatter(x, i):
        x.index_put_((i,), torch.ones(1024))
        return x

    rec = op_cost.record(scatter, (x, idx))
    cost = op_cost.cost_of_recording(rec)
    update = 1024 * 8 + 1024 * 4  # int64 indices + float32 values
    assert cost.gather_bytes == update
    assert counters.op_census(rec)["scatter"] == 1
    srt = op_cost.cost_of_recording(
        op_cost.record(lambda x: torch.sort(x).values, (x,)))
    assert srt.nonvec_flops == 5.0 * 2 * 4096  # values and indices


def test_while_loop_node_is_one_unknown_trip():
    """A ``while_loop`` node is one op: one trip in unknown_trip_counts,
    counted in the census; its body is not recorded."""
    from torch._higher_order_ops.while_loop import while_loop

    def f(x):
        return while_loop(lambda i, x: i < 3, lambda i, x: (i + 1, x @ x),
                          (torch.tensor(0), x))

    rec = op_cost.record(f, (torch.ones((8, 8)),))
    ev = counters.events_from_compiled(rec)
    assert ev.unknown_trip_counts == 1 and ev.while_trip_counts == []
    assert ev.census["while"] == 1


def test_recording_keeps_no_tensor():
    rec = op_cost.record(lambda a: (a @ a).relu(), (torch.ones((16, 16)),))
    from torch.utils._pytree import tree_leaves

    leaves = [x for op in rec.ops
              for x in tree_leaves((op.args, op.kwargs, op.outputs))]
    assert leaves and not any(isinstance(x, torch.Tensor) for x in leaves)
    assert [op.key for op in rec.ops] == ["mm", "relu"]
    assert op_cost.rule_of(rec.ops[0]) == "product"


def test_analyze_compiled_takes_a_recording():
    rec = op_cost.record(lambda a: a @ a, (torch.ones((64, 64)),))
    result = analyze_compiled("adhoc", rec, hw.H100)
    assert result.source == "compiled" and result.chip == "h100"
    assert result.events.mxu_flops == 2 * 64**3


# ---------------------------------------------------------------------------
# The vectorization_report workloads against the reference's compiled source
# ---------------------------------------------------------------------------

EXAMPLES = ("gemm-512", "stream-triad", "gather-reduce", "scan-8-layers",
            "fft2d")
#: the port's own (flops, bytes_accessed): unfused eager counts
EXAMPLE_PINNED = {
    "gemm-512": (268435456.0, 3145728.0),
    "stream-triad": (524288.0, 5242880.0),
    "gather-reduce": (262145.0, 3145732.0),
    "scan-8-layers": (2149580800.0, 41943040.0),
    "fft2d": (1835008.0, 10485760.0),
}
#: Fig. 8 classes on grace-core, grace-socket, tpu-v5e, tpu-v5p, h100
EXAMPLE_CLASSES = {
    "gemm-512": [4, 4, 4, 4, 4],
    "stream-triad": [2, 2, 4, 4, 2],
    "gather-reduce": [3, 3, 4, 4, 3],
    "scan-8-layers": [4, 4, 4, 4, 4],
    "fft2d": [2, 2, 4, 4, 2],
}


def _ref_example_workloads(port_wls):
    """The reference example's five functions on the port's own inputs."""
    args = {wl.name: tuple(jnp.asarray(a.numpy()) for a in wl.example_args())
            for wl in port_wls}
    # jax runs without x64: the gather's int64 indices become int32, whose
    # bytes are no output's
    args["gather-reduce"] = (args["gather-reduce"][0],
                             args["gather-reduce"][1].astype(jnp.int32))

    def scanned(x):
        def body(c, _):
            return jnp.tanh(c @ c), None
        return jax.lax.scan(body, x, None, length=8)[0]

    fns = {"gemm-512": lambda x, y: x @ y,
           "stream-triad": lambda x, y: x + 3.0 * y,
           "gather-reduce": lambda x, i: jnp.take(x, i).sum(),
           "scan-8-layers": scanned,
           "fft2d": lambda x, _: jnp.abs(jnp.fft.fft2(x))}
    return [RefWorkload(name=n, fn=fns[n], args=args[n]) for n in EXAMPLES]


@pytest.fixture(scope="module")
def example_results():
    wls = vectorization_report.build_workloads()
    assert [wl.name for wl in wls] == list(EXAMPLES)
    chips = [hw.get_chip(c) for c in REF_CHIPS + ("h100",)]
    got = analyze_sweep(wls, chips, cache=ArtifactCache(), jobs=4)
    want = ref_analyze_sweep(_ref_example_workloads(wls),
                             [ref_hw.get_chip(c) for c in REF_CHIPS],
                             cache=RefCache(), jobs=4)
    by = {}
    for i, name in enumerate(EXAMPLES):
        by[name] = (got[i * 5:(i + 1) * 5], want[i * 4:(i + 1) * 4])
    return by


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_workload_matches_reference(example_results, name):
    got, want = example_results[name]
    assert all(r.source == "compiled" for r in got + want)
    assert [int(r.perf_class) for r in got[:4]] == \
        [int(r.perf_class) for r in want]
    assert [int(r.perf_class) for r in got] == EXAMPLE_CLASSES[name]
    ev, ref = got[0].events, want[0].events
    for field in ("mxu_flops", "gather_bytes", "nonvec_flops"):
        assert getattr(ev, field) == pytest.approx(getattr(ref, field),
                                                   rel=1e-6), field
    assert (ev.flops, ev.bytes_accessed) == EXAMPLE_PINNED[name]


def test_ad_hoc_workload_without_a_model_resolves_to_compiled():
    x = torch.from_numpy(_randn(7, (128, 128)))
    wl = Workload(name="adhoc-matmul", fn=lambda a: a @ a, args=(x,))
    assert not wl.has_analytic_model
    result = analyze(wl, hw.GRACE_CORE, cache=ArtifactCache())
    assert result.source == "compiled"
    assert result.events.flops >= 2 * 128**3
    with pytest.raises(ValueError, match="no analytic model"):
        analyze(wl, source="analytic", cache=ArtifactCache())


# ---------------------------------------------------------------------------
# The registry's kernel workloads, source="compiled"
# ---------------------------------------------------------------------------

KERNEL_WORKLOADS = ("kernel/flash-decode", "kernel/flash-prefill",
                    "kernel/gemm", "kernel/jacobi2d", "kernel/qc-gate",
                    "kernel/spmv", "kernel/stream-triad")
#: the port's own (flops, bytes_accessed, gather_bytes, class on
#: grace-core and h100), recorded through each kernel's plain version
KERNEL_PINNED = {
    "kernel/flash-decode": (77380.0, 136756.0, 0.0, 2, 2),
    "kernel/flash-prefill": (1147594.0, 968168.0, 50176.0, 4, 4),
    "kernel/gemm": (33619968.0, 1835008.0, 0.0, 4, 4),
    "kernel/jacobi2d": (388116.0, 3879120.0, 0.0, 2, 2),
    "kernel/qc-gate": (163840.0, 1441800.0, 0.0, 2, 2),
    "kernel/spmv": (329857.0, 3035152.0, 262144.0, 2, 2),
    "kernel/stream-triad": (524288.0, 5242884.0, 0.0, 2, 2),
}


@pytest.fixture(scope="module")
def kernel_results():
    assert list_workloads(tags=("kernel",)) == list(KERNEL_WORKLOADS)
    got = analyze_sweep(KERNEL_WORKLOADS, (hw.GRACE_CORE, hw.H100),
                        source="compiled", cache=ArtifactCache(), jobs=4)
    want = ref_analyze_sweep(KERNEL_WORKLOADS, (ref_hw.GRACE_CORE,),
                             source="compiled", cache=RefCache(), jobs=4)
    return {name: (got[2 * i:2 * i + 2], want[i])
            for i, name in enumerate(KERNEL_WORKLOADS)}


@pytest.mark.parametrize("name", KERNEL_WORKLOADS)
def test_kernel_workload_products_equal_reference(kernel_results, name):
    (core, h100), ref = kernel_results[name]
    ev = core.events
    assert core.source == h100.source == "compiled"
    assert ev.mxu_flops == pytest.approx(ref.events.mxu_flops, rel=1e-9)
    assert ev.mxu_flops == {"kernel/gemm": 2.0 * 256**3,
                            "kernel/flash-decode": 65536.0,
                            "kernel/flash-prefill": 1048576.0}.get(name, 0.0)
    flops, nbytes, gather, c_core, c_h100 = KERNEL_PINNED[name]
    assert (ev.flops, ev.bytes_accessed, ev.gather_bytes) == \
        (flops, nbytes, gather)
    assert (int(core.perf_class), int(h100.perf_class)) == (c_core, c_h100)
