"""The port's analysis path (hw, counters, Eq. 1 metrics, adapted roofline,
decision tree, profiler, Workload API, pipeline, AnalysisService) against
the reference's.

The registered kernel workloads keep the reference's problem sizes and
analytic models, so ``analyze`` on them gives the reference's numbers
exactly (the same Python arithmetic on the same inputs): every field of
``to_dict()`` but ``tuning`` (the autotuner's outlook, whose configs are
the card's launch variants: only its keys are the reference's), ``wall_s``
and the event fields only XLA artifacts fill.  SpMV's
example matrix comes from a torch.Generator, not jax.random, so its nnz and
absolute flops/bytes differ; its per-nnz quantities (AI, gather share, VB,
R_ins, class) do not.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import ArtifactCache  # noqa: E402
from repro.analysis import analyze as ref_analyze  # noqa: E402
from repro.analysis import analyze_events as ref_analyze_events  # noqa: E402
from repro.analysis import list_workloads as ref_list_workloads  # noqa: E402
from repro.core import decision_tree as ref_tree  # noqa: E402
from repro.core import hw as ref_hw  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core import roofline as ref_roofline  # noqa: E402
from repro.core.counters import Events as RefEvents  # noqa: E402
from repro.serve.analysis_service import (  # noqa: E402
    AnalysisService as RefService,
)
from repro_torch import analysis  # noqa: E402
from repro_torch.analysis import ArtifactCache as PortCache  # noqa: E402
from repro_torch.analysis import ArtifactStore  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    SVEAnalysis, Workload, analyze, analyze_events, analyze_sweep,
    format_table, get_workload, list_workloads, register, register_lazy,
    workload,
)
from repro_torch.core import (  # noqa: E402
    counters, decision_tree, hw, metrics, profiler, roofline,
)
from repro_torch.core.decision_tree import PerfClass  # noqa: E402
from repro_torch.serve.analysis_service import (  # noqa: E402
    AnalysisRequest, AnalysisService, main,
)

ROOT = Path(__file__).resolve().parents[1]
REF_CHIPS = ("grace-core", "grace-socket", "tpu-v5e", "tpu-v5p")
EXACT = ("kernel/gemm", "kernel/stream-triad", "kernel/jacobi2d",
         "kernel/qc-gate", "kernel/flash-decode", "kernel/flash-prefill")
#: event fields only the reference's compiled (XLA) source fills
HLO_ONLY = ("census", "xla_raw_flops", "xla_raw_bytes", "hlo_traffic_bytes",
            "while_trip_counts", "unknown_trip_counts",
            "argument_bytes_per_device", "output_bytes_per_device",
            "temp_bytes_per_device", "code_bytes_per_device")
#: quantities per nonzero of SpMV, which do not depend on the draw
PER_NNZ = ("workload", "chip", "dtype", "source", "vb", "r_ins", "ai",
           "ai_inflection", "bound", "predicted_speedup", "perf_class",
           "perf_class_name", "gather_fraction", "vectorizable_fraction")


def _comparable(d: dict) -> dict:
    d = {k: v for k, v in d.items() if k not in ("tuning", "wall_s")}
    d["events"] = {k: v for k, v in d["events"].items() if k not in HLO_ONLY}
    return d


def _outcome(fn):
    """(True, value) or (False, exception type name)."""
    try:
        return True, fn()
    except Exception as e:  # noqa: BLE001 — compared with the reference's
        return False, type(e).__name__


# ---------------------------------------------------------------------------
# core: hw, metrics, roofline, decision tree, counters, profiler
# ---------------------------------------------------------------------------


def test_reference_chips_and_elen_table_are_copied_verbatim():
    for name in REF_CHIPS:
        assert dataclasses.asdict(hw.get_chip(name)) == \
            dataclasses.asdict(ref_hw.get_chip(name))
    assert dict(hw.ELEN_BITS) == dict(ref_hw.ELEN_BITS)
    assert hw.DEFAULT_CHIP.name == ref_hw.DEFAULT_CHIP.name
    for dtype in ref_hw.ELEN_BITS:
        assert hw.elen_bits(dtype) == ref_hw.elen_bits(dtype)
    with pytest.raises(KeyError):
        hw.elen_bits("fp128")
    with pytest.raises(KeyError, match="unknown chip"):
        hw.get_chip("a100")


def test_h100_spec_is_the_data_sheet_card():
    h = hw.get_chip("h100")
    assert h is hw.H100
    assert h.peak("fp64") == 34e12 and h.peak("fp32") == 67e12
    assert h.peak("bf16") == h.peak("fp16") == 989e12
    assert h.peak("int8") == 1979e12
    assert h.hbm_bw == 3.35e12 and h.ici_bw() == pytest.approx(900e9)
    assert h.vlen_bits == 1024 and h.transaction_bytes == 32
    assert h.peak("scalar") == h.peak("fp32") / 32
    assert h.peak("scalar_fp64") == h.peak("fp64") / 32
    assert metrics.vectorization_bound(h, "fp32") == 32.0
    assert metrics.vectorization_bound(h, "bf16") == 64.0


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_eq1_metrics_equal_reference(chip):
    c, rc = hw.get_chip(chip), ref_hw.get_chip(chip)
    for dtype in ref_hw.ELEN_BITS:
        assert metrics.vectorization_bound(c, dtype) == \
            ref_metrics.vectorization_bound(rc, dtype)
        assert metrics.packing_factor(dtype) == ref_metrics.packing_factor(dtype)
        for n in (0, 1, 1000, 1 << 20):
            assert metrics.vector_issues(n, dtype, c) == \
                ref_metrics.vector_issues(n, dtype, rc)
        ragged = [0, 1, 17, 128, 129]
        assert metrics.vector_issues(0, dtype, c, ragged_extents=ragged,
                                     tile=128) == \
            ref_metrics.vector_issues(0, dtype, rc, ragged_extents=ragged,
                                      tile=128)
        assert metrics.lane_utilization(300, 4, dtype, c) == \
            ref_metrics.lane_utilization(300, 4, dtype, rc)
    for a, b in [(10, 5), (0, 0), (3, 0), (7, 2)]:
        assert metrics.instruction_reduction(a, b) == \
            ref_metrics.instruction_reduction(a, b)
        assert metrics.arithmetic_intensity(a, b) == \
            ref_metrics.arithmetic_intensity(a, b)
    for vb, f in [(4, 1.0), (32, 0.5), (8, 0.0), (2, 1.5)]:
        assert metrics.amdahl_r_ins(vb, f) == ref_metrics.amdahl_r_ins(vb, f)
    assert metrics.scalar_issues(12) == ref_metrics.scalar_issues(12)


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_roofline_and_decision_tree_equal_reference(chip):
    c, rc = hw.get_chip(chip), ref_hw.get_chip(chip)
    reports = [
        dict(flops=2e9, hbm_bytes=1e9, gather_bytes=0.0),
        dict(flops=2e9, hbm_bytes=1e10, gather_bytes=4e9),
        dict(flops=2e12, hbm_bytes=1e9, gather_bytes=0.0),
        dict(flops=1e9, hbm_bytes=1e10, gather_bytes=0.0),
    ]
    for dtype in ref_hw.ELEN_BITS:
        ok, rl = _outcome(lambda: roofline.adapted_roofline(c, dtype))
        rok, rrl = _outcome(lambda: ref_roofline.adapted_roofline(rc, dtype))
        assert ok == rok, dtype
        if not ok:
            assert rl == rrl
            continue
        assert dataclasses.asdict(rl) == dataclasses.asdict(rrl)
        for ai in (0.01, 0.5, 10.0, 1e4):
            assert rl.attainable(ai) == rrl.attainable(ai)
            assert rl.predicted_speedup(ai) == rrl.predicted_speedup(ai)
            assert rl.region(ai, False) == rrl.region(ai, False)
        for fields in reports:
            for frac in (1.0, 0.05):
                kw = dict(name="r", dtype=dtype, ins_scalar=100.0,
                          ins_vec=25.0, vectorizable_fraction=frac, **fields)
                d = decision_tree.classify(
                    metrics.VectorizationReport(**kw), c)
                rd = ref_tree.classify(ref_metrics.VectorizationReport(**kw),
                                       rc)
                assert int(d.perf_class) == int(rd.perf_class)
                assert dataclasses.asdict(d) | {"perf_class": 0} == \
                    dataclasses.asdict(rd) | {"perf_class": 0}


def test_events_round_trip_and_match_reference():
    ev = counters.events_from_analytic(flops=3e9, hbm_bytes=2e9,
                                       gather_bytes=1e9, mxu_flops=1e9,
                                       collective_bytes=5.0, n_devices=2)
    ev.collectives = counters.CollectiveStats({"all-reduce": 8.0},
                                              {"all-reduce": 1})
    ev.census = {"dot": 2}
    assert counters.Events.from_dict(ev.to_dict()) == ev
    assert RefEvents.from_dict(ev.to_dict()).to_dict() == ev.to_dict()
    assert ev.collectives.total_bytes == 8.0
    assert ev.collectives.total_count == 1


def test_profiler_api_times_an_roi():
    prof = profiler.Profiler()
    with pytest.raises(RuntimeError, match="configure_measure"):
        prof.start_measure()
    prof.configure_measure()
    prof.start_measure()
    torch.ones(1000).sum()
    prof.stop_measure()
    assert prof.mean_roi_s() > 0.0
    m = prof.record("roi", counters.events_from_analytic(flops=2.0,
                                                        hbm_bytes=64.0))
    assert m.counters["VFP_SPEC"] == 2.0 and m.repeats == 1
    assert "[ROI roi]" in prof.print_results()
    with pytest.raises(ValueError, match="at most 6"):
        profiler.Profiler(events=tuple("abcdefg"))
    assert profiler.time_fn(torch.add, torch.ones(8), torch.ones(8),
                            repeats=2, min_time_s=0.0) > 0.0


# ---------------------------------------------------------------------------
# the Workload API
# ---------------------------------------------------------------------------


def test_registry_lists_the_ported_kernel_workloads():
    names = list_workloads()
    for k in ("gemm", "stream-triad", "spmv", "jacobi2d", "qc-gate",
              "flash-decode", "flash-prefill"):
        assert f"kernel/{k}" in names
    assert list_workloads(tags=("kernel",)) == \
        ref_list_workloads(tags=("kernel",))
    assert len(list_workloads(tags=("kernel",))) == 7
    with pytest.raises(KeyError, match="unknown workload"):
        get_workload("kernel/nope")


def test_workload_decorator_registers_and_returns_fn():
    @workload(name="test/torch-saxpy", dtype="fp32",
              args=lambda: (torch.ones(128), torch.ones(128)),
              flops=256.0, hbm_bytes=128 * 3 * 4.0, replace=True)
    def saxpy(x, y):
        return x + 2.0 * y

    wl = get_workload("test/torch-saxpy")
    assert wl.fn is saxpy and saxpy.__workload__ is wl
    assert wl.has_analytic_model and len(wl.example_args()) == 2
    assert analyze(wl).perf_class == PerfClass.MEMORY_BANDWIDTH_BOUND
    register(Workload(name="test/torch-dup"), replace=True)
    with pytest.raises(ValueError, match="already registered"):
        register(Workload(name="test/torch-dup"))


def test_lazy_registration_and_clear_registry_rediscover():
    built = []

    def builder():
        built.append(1)
        return Workload(name="test/torch-lazy", flops=1.0, hbm_bytes=1.0)

    register_lazy("test/torch-lazy", builder, tags=("lazy",), replace=True)
    assert list_workloads(tags=("lazy",)) == ["test/torch-lazy"]
    assert built == []
    assert get_workload("test/torch-lazy").tags == ("lazy",)
    assert built == [1]
    analysis.clear_registry()
    assert "test/torch-lazy" not in list_workloads()
    assert "kernel/gemm" in list_workloads()


def test_args_on_moves_example_arguments_once():
    wl = get_workload("kernel/stream-triad")
    args = wl.args_on(torch.device("cpu"))
    assert args[2] == 3.0 and args[0] is wl.example_args()[0]
    assert wl.args_on(torch.device("cpu")) is args


# ---------------------------------------------------------------------------
# analyze
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", EXACT)
@pytest.mark.parametrize("chip", REF_CHIPS)
def test_analyze_equals_reference(name, chip):
    for dtype in ref_hw.ELEN_BITS:
        rok, want = _outcome(lambda: ref_analyze(
            name, ref_hw.get_chip(chip), dtype=dtype).to_dict())
        ok, got = _outcome(lambda: analyze(name, hw.get_chip(chip),
                                           dtype=dtype).to_dict())
        assert ok == rok, (dtype, got, want)
        if ok:
            assert _comparable(got) == _comparable(want), dtype
            # the reference's rule: an outlook for kernel workloads, with
            # the reference's keys; the configs are the card's launch
            # variants, not the TPU's tiles.  At the workloads' own dtype
            # both have one; at another the port's has none where its
            # kernel takes no operand of that dtype (the GEMM in fp16)
            if dtype == "fp32":
                assert got["tuning"] is not None
                assert want["tuning"] is not None
            if got["tuning"] is not None:
                assert set(got["tuning"]) == set(want["tuning"])
            assert got["wall_s"] is None
        else:
            assert got == want


@pytest.mark.parametrize("chip", REF_CHIPS)
def test_spmv_analysis_matches_reference_per_nonzero(chip):
    for dtype in ("fp32", "bf16", "fp64"):
        rok, want = _outcome(lambda: ref_analyze(
            "kernel/spmv", ref_hw.get_chip(chip), dtype=dtype).to_dict())
        ok, got = _outcome(lambda: analyze(
            "kernel/spmv", hw.get_chip(chip), dtype=dtype).to_dict())
        assert ok == rok
        if ok:
            for key in PER_NNZ:
                assert got[key] == pytest.approx(want[key], rel=1e-12), key


@pytest.mark.parametrize("name,expected", [
    ("kernel/stream-triad", PerfClass.MEMORY_BANDWIDTH_BOUND),  # Class 2
    ("kernel/jacobi2d", PerfClass.MEMORY_BANDWIDTH_BOUND),      # Class 2
    ("kernel/spmv", PerfClass.MEMORY_LATENCY_BOUND),            # Class 3
    ("kernel/gemm", PerfClass.SPEEDUP),                         # Class 4
    ("kernel/qc-gate", PerfClass.MEMORY_BANDWIDTH_BOUND),       # Class 2
    ("kernel/flash-decode", PerfClass.SPEEDUP),                 # Class 4
    ("kernel/flash-prefill", PerfClass.SPEEDUP),                # Class 4
])
def test_analyze_golden_classes(name, expected):
    result = analyze(name)  # default chip: the paper's grace-core model
    assert isinstance(result, SVEAnalysis)
    assert result.perf_class == expected
    assert result.vb == 4.0 and result.r_ins > 1.0 and result.ai > 0.0
    assert result.bound in ("memory-bound", "compute-bound")
    assert int(ref_analyze(name).perf_class) == int(expected)


@pytest.mark.parametrize("name,expected,bound", [
    ("kernel/stream-triad", PerfClass.MEMORY_BANDWIDTH_BOUND, "memory-bound"),
    ("kernel/jacobi2d", PerfClass.MEMORY_BANDWIDTH_BOUND, "memory-bound"),
    ("kernel/spmv", PerfClass.MEMORY_LATENCY_BOUND, "memory-bound"),
    ("kernel/gemm", PerfClass.SPEEDUP, "compute-bound"),
    ("kernel/qc-gate", PerfClass.MEMORY_BANDWIDTH_BOUND, "memory-bound"),
    ("kernel/flash-decode", PerfClass.SPEEDUP, "memory-bound"),
    ("kernel/flash-prefill", PerfClass.SPEEDUP, "memory-bound"),
])
def test_h100_classes_are_pinned(name, expected, bound):
    """fp32 on the H100 model: VB 32, scalar knee 2.094 TFLOP/s / 3.35 TB/s
    = 0.625 flop/B, vector knee 20 flop/B, latency threshold 13%."""
    r = analyze(name, hw.H100)
    assert r.perf_class == expected and r.bound == bound
    assert r.vb == 32.0 and r.r_ins == 32.0
    assert r.ai_inflection == pytest.approx(0.625)
    assert r.roofline.ai_irv == pytest.approx(20.0)
    assert r.decision.latency_threshold == 0.13


def test_report_is_serializable_and_tabulates():
    result = analyze("kernel/gemm", hw.H100)
    d = json.loads(result.to_json())
    assert d["chip"] == "h100" and d["perf_class"] == 4
    assert "kernel/gemm" in result.table() and "class" in format_table([result])
    assert "Class 4" in str(result)
    assert format_table([]) == "(no results)"


def test_analyze_events_equals_reference():
    ev = counters.events_from_analytic(flops=4e9, hbm_bytes=1e9,
                                       gather_bytes=2e8)
    for chip in REF_CHIPS:
        got = analyze_events("cell", ev, hw.get_chip(chip)).to_dict()
        want = ref_analyze_events("cell", RefEvents.from_dict(ev.to_dict()),
                                  ref_hw.get_chip(chip)).to_dict()
        assert _comparable(got) == _comparable(want)


def test_unported_sources_and_stores_name_the_roadmap_item(tmp_path):
    """What this test once saw refused is ported (ROADMAP 1.17.1-2): the
    compiled source, a workload without an analytic model (``"auto"``
    resolves it to the compiled source, as the reference's does),
    ``cache=`` and ``store=``.  An unknown source is still refused."""
    cache = PortCache()
    compiled = analyze("kernel/gemm", source="compiled", cache=cache)
    assert compiled.source == "compiled" and cache.compiles == 1
    assert compiled.events.mxu_flops == 2 * 256**3
    nomodel = analyze(Workload(name="no-model", fn=torch.ones, args=(3,)),
                      cache=cache)
    assert nomodel.source == "compiled" and cache.compiles == 2
    assert analyze("kernel/gemm", cache=cache).source == "analytic"
    stored = analyze("kernel/gemm", source="compiled", store=str(tmp_path))
    assert stored.to_dict() == compiled.to_dict()
    assert len(ArtifactStore(str(tmp_path)).entries()) == 1
    with pytest.raises(ValueError, match="source must be"):
        analyze("kernel/gemm", source="hlo")


def test_time_roi_measures_wall_time_on_the_cpu():
    result = analyze("kernel/stream-triad", time_roi=True, device="cpu")
    assert result.wall_s is not None and result.wall_s > 0.0


def test_time_roi_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        analyze("kernel/stream-triad", time_roi=True)


def test_analyze_sweep_order_and_jobs():
    names = ["kernel/gemm", "kernel/spmv"]
    chips = (hw.GRACE_CORE, hw.H100)
    serial = analyze_sweep(names, chips, dtypes=("fp32", "bf16"))
    parallel = analyze_sweep(names, chips, dtypes=("fp32", "bf16"), jobs=4)
    assert [(r.workload, r.chip, r.dtype) for r in serial] == [
        (w, c.name, d) for w in names for c in chips for d in ("fp32", "bf16")]
    assert [r.to_dict() for r in serial] == [r.to_dict() for r in parallel]
    assert len(analyze_sweep(chips=(hw.H100,))) == len(list_workloads())


# ---------------------------------------------------------------------------
# AnalysisService
# ---------------------------------------------------------------------------


def test_service_waves_and_report_equal_reference():
    names = ["kernel/gemm", "kernel/stream-triad", "kernel/jacobi2d",
             "kernel/spmv", "kernel/qc-gate", "kernel/flash-decode",
             "kernel/flash-prefill"]
    svc = AnalysisService(max_batch=3, device="cpu")
    ref = RefService(max_batch=3, cache=ArtifactCache())
    for n in names:
        svc.submit(n, chips=("grace-core", "tpu-v5e"), dtypes=("fp32", "bf16"))
        ref.submit(n, chips=("grace-core", "tpu-v5e"), dtypes=("fp32", "bf16"))
    svc.run_until_drained()
    ref.run_until_drained()
    assert svc.waves == ref.waves == 3
    got, want = svc.report(), ref.report()
    assert got["kind"] == want["kind"] and got["schema"] == want["schema"]
    for key in ("requests", "cells", "waves", "max_batch", "jobs", "errors"):
        assert got["service"][key] == want["service"][key], key
    for greq, wreq in zip(got["requests"], want["requests"]):
        assert {k: v for k, v in greq.items() if k != "results"} == \
            {k: v for k, v in wreq.items() if k != "results"}
        for g, w in zip(greq["results"], wreq["results"]):
            if greq["workload"] == "kernel/spmv":
                assert {k: g[k] for k in PER_NNZ} == \
                    pytest.approx({k: w[k] for k in PER_NNZ}, rel=1e-12)
            else:
                assert _comparable(g) == _comparable(w)


def test_service_request_sweeps_chips_and_dtypes():
    svc = AnalysisService(device="cpu")
    req = svc.submit("kernel/stream-triad", chips=("grace-core", "h100"),
                     dtypes=("fp64", "fp32", "fp16"))
    svc.run_until_drained()
    assert [r.vb for r in req.results] == [2.0, 4.0, 8.0, 16.0, 32.0, 64.0]


def test_service_failures_are_captured_per_request():
    def broken_builder():
        raise RuntimeError("builder exploded")

    register_lazy("test/torch-broken", broken_builder, replace=True)
    svc = AnalysisService(jobs=2, device="cpu")
    bad = svc.submit("test/torch-broken")
    nomodel = svc.submit(Workload(name="test/no-model", fn=torch.ones,
                                  args=(2,)))
    ok = svc.submit(AnalysisRequest(uid=-1, workload="kernel/gemm"))
    svc.run_until_drained()
    assert "builder exploded" in bad.error and bad.results == []
    # a workload without an analytic model analyses through the compiled
    # source (ROADMAP 1.17.1), where it once failed its request
    assert nomodel.error is None
    assert [r.source for r in nomodel.results] == ["compiled"]
    assert ok.error is None and ok.results[0].perf_class == PerfClass.SPEEDUP
    assert svc.report()["service"]["errors"] == 1
    assert [r.uid for r in (bad, nomodel, ok)] == [0, 1, 2]


def test_service_times_rois_on_its_device():
    svc = AnalysisService(device="cpu")
    req = svc.submit("kernel/gemm", chips=("h100",), time_roi=True)
    svc.run_until_drained()
    assert req.results[0].wall_s > 0.0
    assert svc.report()["service"]["device"] == "cpu"


def _cli(*argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.analysis_service", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def test_cli_prints_a_json_report():
    proc = _cli("--device", "cpu", "--workloads", "kernel/gemm",
                "kernel/spmv", "kernel/qc-gate", "--chips", "grace-core",
                "h100")
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["service"]["cells"] == 6
    classes = {(r["workload"], r["chip"]): r["perf_class"]
               for req in report["requests"] for r in req["results"]}
    assert classes == {("kernel/gemm", "grace-core"): 4,
                       ("kernel/gemm", "h100"): 4,
                       ("kernel/spmv", "grace-core"): 3,
                       ("kernel/spmv", "h100"): 3,
                       ("kernel/qc-gate", "grace-core"): 2,
                       ("kernel/qc-gate", "h100"): 2}
    assert "MEMORY_LATENCY_BOUND" in proc.stderr  # the table


def test_cli_drains_every_kernel_workload_by_default():
    """With no --workloads the service analyses the seven kernel workloads,
    the reference's, timing each ROI on --device."""
    proc = _cli("--device", "cpu", "--chips", "h100", "--time-roi")
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    got = {r["workload"]: (r["perf_class"], r["wall_s"] > 0)
           for req in report["requests"] for r in req["results"]}
    assert sorted(got) == ref_list_workloads(tags=("kernel",))
    assert all(timed for _, timed in got.values())
    assert {n: c for n, (c, _) in got.items()} == {
        "kernel/flash-decode": 4, "kernel/flash-prefill": 4,
        "kernel/gemm": 4, "kernel/jacobi2d": 2, "kernel/qc-gate": 2,
        "kernel/spmv": 3, "kernel/stream-triad": 2}


def test_cli_refuses_what_is_not_ported_and_unknown_workloads(
        tmp_path, monkeypatch):
    """``--store-dir``/``--no-store``, once refused, are ported (ROADMAP
    1.17.2) and accepted; ``--record`` (1.15) appends the report to the
    perf ledger, as the reference's ``analysis_service.py:345-372`` does:
    chip the first swept, dtype the one the cells share, and ``run_id`` and
    ``trajectory`` stamped into the report.  The ledger rides the store:
    ``<store-dir>/perf``, and the default store's is the default ledger."""
    from repro_torch.perf import Ledger

    store = tmp_path / "store"
    for flags in (["--no-store"], ["--store-dir", str(store), "--record"]):
        assert main(["--device", "cpu", "--workloads", "kernel/qc-gate",
                     "--source", "compiled", *flags,
                     "--out", str(tmp_path / "s.json")]) == 0
    (stored,) = Ledger(str(store / "perf")).runs()
    assert sorted(stored.metrics) == ["kernel/qc-gate@grace-core/fp32"]
    assert len(ArtifactStore(str(store)).entries()) == 1
    assert main(["--device", "cpu", "--workloads", "kernel/nope"]) == 2
    out = tmp_path / "r.json"
    assert main(["--device", "cpu", "--workloads", "kernel/jacobi2d",
                 "--chips", "h100", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["requests"][0]["results"][0][
        "perf_class"] == 2

    from repro_torch.perf import default_ledger

    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path / "art"))
    assert main(["--device", "cpu", "--workloads", "kernel/jacobi2d",
                 "kernel/gemm", "--chips", "h100", "grace-core", "--record",
                 "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    (run,) = default_ledger().runs()
    assert report["run_id"] == run.run_id
    assert report["trajectory"] == {"runs": 1, "latest_run_id": run.run_id,
                                    "series": ["h100/fp32"]}
    assert run.meta == {"kind": "analysis_service",
                        "sources": ["analysis"]}
    assert sorted(run.metrics) == [
        "kernel/gemm@grace-core/fp32", "kernel/gemm@h100/fp32",
        "kernel/jacobi2d@grace-core/fp32", "kernel/jacobi2d@h100/fp32"]
    assert run.metric("kernel/jacobi2d@h100/fp32", "perf_class") == 2
