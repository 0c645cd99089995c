"""The port's roofline-guided autotuner (``repro_torch.tuning``) against
the reference's (``repro.tuning``), on the CPU.

* The machinery is the reference's: fed the reference's own GEMM, STREAM
  and flash-prefill spaces and the same numpy inputs, the port's
  ``TuningSpace``, ``prune`` and ``predicted_time_s`` give the reference's
  candidates, order, subsets, survivors, pruned counts and predicted
  times; records written by either package read back field for field in
  the other; ``SVEAnalysis.tuning`` and the analysis service's ``tuning``
  block carry the reference's keys where the reference's do.
* The port's own spaces are CUDA launch variants: each default is the
  constant the kernel ran before it had variants, every candidate passes
  its plan function and fits the 232,448 bytes of shared memory a block
  may use, and the plain versions give the same numbers under every
  candidate; a keyword no variant covers raises on the CPU too.
* The tuner's contracts, each a case of the reference's tests on the
  port's spaces (``mode="interpret"``, the plain versions, on the CPU):
  persisted records, zero timing runs on a store hit (in this process and
  in a second one), corrupt records healed, never shipping a config
  slower than the default, KernelOps resolving tuned configs with
  explicit keywords winning, the fingerprints and the ledger's tuned-state
  hash following the active config; ``mode="compiled"`` raises on CPU
  tensors.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.analysis import analyze as ref_analyze
from repro.analysis.store import ArtifactStore as RefStore
from repro.core import hw as ref_hw
from repro.tuning import load_record as ref_load_record
from repro.tuning import predicted_time_s as ref_predicted_time_s
from repro.tuning import prune as ref_prune
from repro.tuning import save_record as ref_save_record
from repro.tuning import spaces as ref_spaces
from repro_torch.analysis import Workload, analyze, workload_fingerprint
from repro_torch.analysis.store import ArtifactStore
from repro_torch.core import hw
from repro_torch.core.roofline import adapted_roofline
from repro_torch.kernels import registry
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.gemm import kernel as gemm_k
from repro_torch.kernels.gemm import ops as gemm_ops_mod
from repro_torch.kernels.jacobi2d import kernel as jac
from repro_torch.kernels.qc_gate import kernel as qc
from repro_torch.kernels.registry import get_kernel
from repro_torch.kernels.stream import kernel as stream_k
from repro_torch.perf.ledger import tuned_state_hash
from repro_torch.tuning import (
    TuningRecord,
    TuningSpace,
    load_record,
    load_tuned,
    outlook,
    predicted_time_s,
    prune,
    save_record,
    timing_runs,
    tunable_kernels,
    tune,
    tune_kernels,
    tuning_fingerprint,
)
from repro_torch.tuning.space import SMEM_LIMIT
from repro_torch.tuning.tune import _cast_args

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu", mode="interpret", chip=hw.GRACE_CORE, repeats=1)
SHARED_CHIPS = ("grace-core", "tpu-v5e")


def _gemm_args(n=128, dtype=torch.float32):
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal((n, n),
                                                      np.float32)).to(dtype)
                 for _ in range(2))


def _examples():
    """{registry kernel: its CPU example arguments}: the registry's
    workloads, and the triad's arrays for the other STREAM ops."""
    from repro_torch.analysis import get_workload

    out = {n: tuple(get_workload(f"kernel/{n}").example_args())
           for n in tunable_kernels()}
    a, b, q = out["stream-triad"]
    out.update({"stream-copy": (a,), "stream-scale": (a, q),
                "stream-add": (a, b)})
    return out


SPACED = ("gemm", "stream-copy", "stream-scale", "stream-add",
          "stream-triad", "jacobi2d", "qc-gate", "flash-decode",
          "flash-prefill")


@pytest.fixture
def gemm_ops():
    ops = get_kernel("gemm")
    ops.clear_tuned()
    yield ops
    ops.clear_tuned()


# ---------------------------------------------------------------------------
# The machinery held to the reference's, on the reference's own spaces
# ---------------------------------------------------------------------------


def _port_space(ref_space) -> TuningSpace:
    return TuningSpace(**{f.name: getattr(ref_space, f.name)
                          for f in dataclasses.fields(ref_space)})


def _np_fp_args(B=2, C=16, KV=2, G=4, D=16, bs=8, nb=8):
    rng = np.random.default_rng(0)
    n_blocks = 1 + B * nb
    f = lambda *s: rng.standard_normal(s, np.float32)  # noqa: E731
    return (f(B, C, KV, G, D), f(B, C, KV, D), f(B, C, KV, D),
            f(n_blocks, bs, KV, D), f(n_blocks, bs, KV, D),
            (1 + np.arange(B * nb, dtype=np.int32)).reshape(B, nb),
            np.asarray((24, 0), np.int32))


REF_CASES = {
    "gemm": (ref_spaces.gemm_space,
             lambda: tuple(np.random.default_rng(0).standard_normal(
                 (256, 256), np.float32) for _ in range(2))),
    "stream": (lambda: ref_spaces.stream_space(2, 2.0),
               lambda: (np.ones((320, 128), np.float32),
                        np.ones((320, 128), np.float32), 3.0)),
    "flash-prefill": (ref_spaces.flash_prefill_space, _np_fp_args),
}


@pytest.mark.parametrize("case", sorted(REF_CASES))
def test_machinery_equals_reference_on_its_spaces(case):
    make_space, make_args = REF_CASES[case]
    ref_space = make_space()
    space = _port_space(ref_space)
    args = make_args()
    assert space.size() == ref_space.size()
    assert space.token() == ref_space.token()
    assert space.configs() == ref_space.configs()
    assert space.candidates(args) == ref_space.candidates(args)
    for cap in (1, 2, 3):
        assert (space.subset(cap).candidates(args)
                == ref_space.subset(cap).candidates(args))
        assert space.subset(cap).token() == ref_space.subset(cap).token()
    for chip in SHARED_CHIPS:
        for dtype in ("fp32", "bf16"):
            for keep in (1, 3, 100):
                got = prune(space, args, hw.get_chip(chip), dtype, keep=keep)
                want = ref_prune(ref_space, args, ref_hw.get_chip(chip),
                                 dtype, keep=keep)
                assert got == want, (chip, dtype, keep)


def test_predicted_time_equals_reference():
    from repro.core.roofline import adapted_roofline as ref_roofline

    for chip in SHARED_CHIPS:
        for dtype in ("fp32", "bf16", "fp16"):
            rl = adapted_roofline(hw.get_chip(chip), dtype)
            ref_rl = ref_roofline(ref_hw.get_chip(chip), dtype)
            for flops, nbytes in ((1e9, 1e3), (1e6, 1e9), (3e12, 7e9)):
                assert predicted_time_s(flops, nbytes, rl) == \
                    ref_predicted_time_s(flops, nbytes, ref_rl)


def test_pruning_monotone():
    """The Eq.-2 score never ranks more predicted traffic (or FLOPs)
    ahead of less: the property that makes pruning sound."""
    rl = adapted_roofline(hw.H100, "fp32")
    times = [predicted_time_s(1e9, b, rl) for b in (1e3, 1e6, 1e9, 1e12)]
    assert times == sorted(times)
    times_f = [predicted_time_s(f, 1e6, rl) for f in (1e6, 1e9, 1e12)]
    assert times_f == sorted(times_f)


def _record(**kw):
    base = dict(kernel="k", chip="c", dtype="fp32", fingerprint="f" * 32,
                config={"tile_h": 16}, default_config={"tile_h": 8},
                best_time_s=1.0, default_time_s=2.0, predicted_best_s=0.5,
                predicted_default_s=1.0, space_size=4, candidates=4,
                pruned=2, timed=2, mode="compiled", problem="(4, 4)")
    return {**base, **kw}


def test_records_read_across_packages(tmp_path):
    from repro.tuning import TuningRecord as RefRecord

    port_rec = TuningRecord(**_record())
    save_record(ArtifactStore(str(tmp_path / "a")), port_rec)
    back = ref_load_record(RefStore(str(tmp_path / "a")), port_rec.fingerprint)
    assert back is not None and back.cached
    assert {**back.to_dict(), "cached": False} == port_rec.to_dict()

    ref_rec = RefRecord(**_record(fingerprint="e" * 32, config={"bm": 256}))
    ref_save_record(RefStore(str(tmp_path / "b")), ref_rec)
    got = load_record(ArtifactStore(str(tmp_path / "b")), ref_rec.fingerprint)
    assert got is not None and got.cached
    assert {**got.to_dict(), "cached": False} == ref_rec.to_dict()
    with open(ArtifactStore(str(tmp_path / "b")).path_for(
            ref_rec.fingerprint)) as f:
        payload = json.load(f)
    assert set(payload) == {"workload", "kind", "tuning_version", "record",
                            "version", "fingerprint"}


def test_record_round_trip(tmp_path):
    rec = TuningRecord(**_record())
    store = ArtifactStore(str(tmp_path))
    save_record(store, rec)
    back = load_record(store, rec.fingerprint)
    assert back is not None and back.cached
    assert back.config == {"tile_h": 16} and back.speedup_vs_default == 2.0
    assert json.loads(json.dumps(rec.to_dict())) == rec.to_dict()


def _analytic_workload(module, name):
    return module.Workload(name=name, fn=None, args=(), dtype="fp32",
                           flops=1e9, hbm_bytes=1e8, tags=("example",))


def test_analyze_outlook_exactly_where_the_reference_has_one():
    """An outlook for each kernel workload whose op has a space in the
    reference's registry, and for no other workload (its keys against the
    reference's own outlook: ``test_torch_analysis.py``)."""
    import repro.analysis as ref_analysis
    import repro_torch.analysis as port_analysis
    from repro.kernels.registry import KERNELS as REF_KERNELS

    names = [n for n in port_analysis.list_workloads()
             if n.startswith("kernel/")]
    assert len(names) == 7
    for name in names:
        got = analyze(name, hw.GRACE_CORE).tuning
        ref_op = REF_KERNELS[name[len("kernel/"):]]
        assert (got is None) == (ref_op.tuning_space is None), name
        if got is not None:
            assert got["best_config"] in get_kernel(
                name[len("kernel/"):]).tuning_space.candidates(
                    tuple(port_analysis.get_workload(name).example_args()))
    assert analyze("kernel/spmv").tuning is None
    other = _analytic_workload(port_analysis, "example/stream")
    assert analyze(other).tuning is None
    assert ref_analyze(_analytic_workload(ref_analysis,
                                          "example/stream")).tuning is None
    res = analyze("kernel/gemm", hw.H100)
    assert "tuning" in res.to_dict() and res.row()["tuned"].endswith("x")


def test_service_tuning_block_has_the_reference_keys():
    from repro.analysis import ArtifactCache as RefCache
    from repro.serve.analysis_service import AnalysisService as RefService
    from repro_torch.analysis import ArtifactCache
    from repro_torch.serve.analysis_service import AnalysisService

    reports = []
    for svc in (AnalysisService(cache=ArtifactCache(), device="cpu"),
                RefService(cache=RefCache())):
        svc.submit("kernel/gemm", chips=("grace-core",))
        svc.submit("kernel/spmv", chips=("grace-core",))  # no space
        svc.run_until_drained()
        reports.append(svc.report())
    got, want = reports
    assert set(got["tuning"]) == set(want["tuning"]) == {
        "gemm@grace-core/fp32"}
    assert set(got["tuning"]["gemm@grace-core/fp32"]) == set(
        want["tuning"]["gemm@grace-core/fp32"]) == {
            "best_config", "predicted_speedup", "record"}


# ---------------------------------------------------------------------------
# The port's spaces: CUDA launch variants
# ---------------------------------------------------------------------------


def test_tunable_kernels_are_the_references():
    from repro.tuning import tunable_kernels as ref_tunable

    assert tunable_kernels() == ref_tunable()
    assert get_kernel("spmv").tuning_space is None
    assert get_kernel("spmv-fixed-width").tuning_space is None
    assert all(get_kernel(n).tuning_space is not None for n in SPACED)


def test_space_defaults_are_the_kernels_constants():
    ex = _examples()
    gemm = get_kernel("gemm").tuning_space
    f32, b16 = ex["gemm"], _cast_args(ex["gemm"], "bf16")
    assert tuple(gemm.validate(gemm.default, f32).values()) == (
        *gemm_k.SIMT_TILE, gemm_k.SIMT_STAGES)
    assert tuple(gemm.validate(gemm.default, b16).values()) == (
        *gemm_k.WGMMA_TILE, gemm_k.WGMMA_STAGES)
    for op in ("stream-copy", "stream-scale", "stream-add", "stream-triad"):
        assert get_kernel(op).tuning_space.default == {
            "threads": stream_k.THREADS, "vecs": stream_k.VECS} == {
                "threads": 256, "vecs": 4}
    assert get_kernel("jacobi2d").tuning_space.default == {
        "tile_h": jac.TILE_HS[0]} == {"tile_h": 8}
    assert get_kernel("qc-gate").tuning_space.default == {
        "threads": qc.THREADS[0]} == {"threads": 256}
    assert get_kernel("qc-gate").tuning_space.fixed == {"qubit": 0,
                                                        "theta": 0.25}
    assert get_kernel("flash-decode").tuning_space.default == {
        "split_rows": fd.DECODE_SPLIT} == {"split_rows": 256}
    assert get_kernel("flash-prefill").tuning_space.default == {
        "q_tile": fd.PREFILL_VECTORS, "key_tile": fd.PREFILL_KEYS} == {
            "q_tile": 64, "key_tile": 64}


def _plan_of(name, cfg, args):
    """The kernel's plan function on ``cfg`` (raises where it refuses)."""
    if name == "gemm":
        x, y = args[0], args[1]
        return gemm_k.gemm_plan(x.shape[0], y.shape[1], x.shape[1],
                                x.dtype, True, *cfg.values())
    if name == "flash-decode":
        q, k = args[0], args[1]
        B, KV, G, D = q.shape
        return fd.decode_plan(k.shape[1], fd.DECODE_TILE, B, KV, G, D,
                              cfg["split_rows"])
    if name == "flash-prefill":
        q, kp, bt = args[0], args[3], args[5]
        B, C, KV, G, D = q.shape
        return fd.prefill_plan(C, G, D, kp.shape[1], bt.shape[1], q.dtype,
                               kp.dtype, cfg["q_tile"], cfg["key_tile"])
    return None


@pytest.mark.parametrize("name", SPACED)
def test_every_candidate_passes_its_plan_and_fits(name):
    ex = _examples()[name]
    space = get_kernel(name).tuning_space
    for dtype in space.dtypes:
        args = _cast_args(ex, dtype)
        cands = space.candidates(args)
        assert cands and space.validate(space.default, args) in cands
        for cfg in cands:
            _plan_of(name, cfg, args)
            if space.vmem_model is not None:
                assert space.vmem_model({**space.fixed, **cfg}, args,
                                        4) <= SMEM_LIMIT


def test_gemm_space_keeps_the_planned_routes_variants():
    space = get_kernel("gemm").tuning_space
    f32 = space.candidates(_gemm_args(256))
    b16 = space.candidates(_gemm_args(256, torch.bfloat16))
    assert [tuple(c.values()) for c in f32] == sorted(
        gemm_k.VARIANTS["simt"], reverse=True)
    assert sorted(tuple(c.values()) for c in b16) == sorted(
        gemm_k.VARIANTS["wgmma"])
    # subset(2) keeps both routes' defaults (the CI tiny-space knob)
    tiny = space.subset(2)
    assert tiny.validate(space.default, _gemm_args(256)) in \
        tiny.candidates(_gemm_args(256))
    assert tiny.validate(space.default, _gemm_args(256, torch.bfloat16)) in \
        tiny.candidates(_gemm_args(256, torch.bfloat16))
    assert space.subset(1).size() == 1
    assert space.subset(1).token() != space.token()
    # another route's variant, or one no route compiled, is refused
    assert space.validate({"tile_m": 128, "tile_n": 256, "tile_k": 64,
                           "stages": 4}, _gemm_args(256)) is None
    assert space.validate({"tile_m": 64, "tile_n": 256, "tile_k": 64,
                           "stages": 4}, _gemm_args(256, torch.bfloat16)) \
        is None


def test_space_smem_budget_filters_candidates():
    space = get_kernel("gemm").tuning_space
    args = _gemm_args(256, torch.bfloat16)
    smem = {tuple(c.values()): space.vmem_model(c, args, 2)
            for c in space.candidates(args)}
    tight = dataclasses.replace(space, vmem_budget=140_000)
    kept = [tuple(c.values()) for c in tight.candidates(args)]
    assert kept == [v for v, b in smem.items() if b <= 140_000] == [
        (128, 128, 64, 4)]


def test_gemm_larger_tiles_predict_less_traffic():
    space = get_kernel("gemm").tuning_space
    args = _gemm_args(512)
    big = space.traffic_model({"tile_m": 128, "tile_n": 128}, args)
    small = space.traffic_model({"tile_m": 64, "tile_n": 64}, args)
    assert big < small


def test_prune_orders_by_predicted_time_and_counts():
    space = get_kernel("flash-prefill").tuning_space
    args = _examples()["flash-prefill"]
    survivors, pruned = prune(space, args, hw.H100, "fp32", keep=3)
    assert len(survivors) == 3 and pruned == 1  # 4 candidates
    scores = [s for _, s in survivors]
    assert scores == sorted(scores)
    everything, none = prune(space, args, hw.H100, "fp32", keep=100)
    assert none == 0 and len(everything) == 4


def test_prefill_traffic_monotone_in_q_tile():
    space = get_kernel("flash-prefill").tuning_space
    args = _examples()["flash-prefill"]
    traffic = [space.traffic_model({"q_tile": qt, "key_tile": 64}, args)
               for qt in (32, 64)]
    assert traffic[0] > traffic[1]
    # int8 pools have only the default variant
    q, kn, vn, kp, vp, bt, qs = args
    i8 = (q, kn, vn, kp.to(torch.int8), vp.to(torch.int8), bt, qs)
    assert [tuple(c.values()) for c in space.candidates(i8)] == [(64, 64)]


def test_decode_split_clamps_to_the_cache():
    space = get_kernel("flash-decode").tuning_space
    args = _examples()["flash-decode"]  # S = 64: one split whatever L
    assert space.candidates(args) == [{"split_rows": 256}]
    q, k, v, vl = args
    long = (q, torch.zeros(2, 4096, 2, 16), torch.zeros(2, 4096, 2, 16), vl)
    assert [c["split_rows"] for c in space.candidates(long)] == [
        256, 128, 512, 1024, 2048]
    traffic = [space.traffic_model({"split_rows": s}, long)
               for s in (128, 256, 512, 1024, 2048)]
    assert traffic == sorted(traffic, reverse=True)


@pytest.mark.parametrize("S", [1, 64, 200, 256, 257, 600, 2048, 2049,
                               4096])
def test_decode_split_clamp_stays_in_the_axes(S):
    """A one-split config collapses onto the default where it covers S,
    else onto the smallest axis value that does; longer splits stay."""
    space = get_kernel("flash-decode").tuning_space
    axis = space.axes["split_rows"]
    q, _, _, vl = _examples()["flash-decode"]
    args = (q, torch.zeros(2, S, 2, 16), torch.zeros(2, S, 2, 16), vl)
    one_split = 256 if S <= 256 else min([r for r in axis if r >= S],
                                             default=None)
    for raw in space.configs():
        rows = space.validate(raw, args)["split_rows"]
        assert rows in axis
        assert rows == (raw["split_rows"] if raw["split_rows"] < S
                        else one_split)


def test_decode_config_tuned_short_resolves_in_the_axes_long(tmp_path):
    """A config tuned at the example problem (S 64) and resolved on a cache
    of 4096 rows is an axis value, the one the record stores."""
    ops = get_kernel("flash-decode")
    ops.clear_tuned()
    try:
        rec = tune(ops, _examples()["flash-decode"], store=str(tmp_path),
                   keep=5, **CPU)
        assert rec.config == {"split_rows": 256}
        assert ops.tuned_config() == rec.config
        q, _, _, vl = _examples()["flash-decode"]
        long = (q, torch.zeros(2, 4096, 2, 16), torch.zeros(2, 4096, 2, 16),
                vl)
        kw = ops._tuned_kwargs(long, {})
        assert kw == rec.config
        assert kw["split_rows"] in ops.tuning_space.axes["split_rows"]
    finally:
        ops.clear_tuned()


@pytest.mark.parametrize("name", SPACED)
def test_plain_versions_equal_under_every_candidate(name):
    """Tiling never changes a result: the plain version under each
    candidate equals its default call."""
    ops = get_kernel(name)
    space = ops.tuning_space
    for dtype in space.dtypes:
        args = _cast_args(_examples()[name], dtype)
        want = ops.interpret(*[a.clone() if isinstance(a, torch.Tensor)
                               else a for a in args], **space.fixed)
        for cfg in space.candidates(args):
            got = ops.interpret(*[a.clone() if isinstance(a, torch.Tensor)
                                  else a for a in args],
                                **space.fixed, **cfg)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                assert torch.equal(g, w), (dtype, cfg)


def test_keywords_no_variant_covers_raise_on_the_cpu():
    ex = _examples()
    x, y = ex["gemm"]
    with pytest.raises(ValueError, match="launch variant"):
        gemm_k.gemm(x, y, tile_n=96)
    with pytest.raises(ValueError, match="launch variant"):
        gemm_k.gemm_plain(x, y, tile_n=256)  # a wgmma tile on the simt route
    a, b, q = ex["stream-triad"]
    with pytest.raises(ValueError, match="launch variant"):
        stream_k.stream_triad(a, b, q, threads=64)
    with pytest.raises(ValueError, match="launch variant"):
        jac.jacobi_step(ex["jacobi2d"][0], tile_h=2)
    with pytest.raises(ValueError, match="launch variant"):
        qc.rx_gate(*ex["qc-gate"], 0, 0.25, threads=64)
    with pytest.raises(ValueError, match="multiple"):
        fd.flash_decode(*ex["flash-decode"], block_s=16, split_rows=100)
    with pytest.raises(ValueError, match="launch variant"):
        fd.flash_prefill(*ex["flash-prefill"], q_tile=16)
    pq, kn, vn, kp, vp, bt, qs = ex["flash-prefill"]
    with pytest.raises(ValueError, match="compiled for"):
        fd.flash_prefill_paged(pq, kn, vn, kp.bfloat16(), vp.bfloat16(), bt,
                               qs, torch.full((2,), 16, dtype=torch.int32),
                               q_tile=32)


def test_gemm_pick_tiles_and_smem():
    bf16, f32 = torch.bfloat16, torch.float32
    assert gemm_ops_mod.pick_tiles(8192, 8192, 8192, bf16) == \
        (*gemm_k.WGMMA_TILE, gemm_k.WGMMA_STAGES)
    assert gemm_ops_mod.pick_tiles(8192, 8192, 8192, f32) == \
        (*gemm_k.SIMT_TILE, gemm_k.SIMT_STAGES)
    assert gemm_ops_mod.pick_tiles(128, 128, 128, bf16) == (128, 128, 64, 4)
    assert gemm_ops_mod.pick_tiles(64, 64, 64, f32) == (64, 64, 16, 2)
    assert gemm_ops_mod.pick_tiles(8192, 8192, 8192, bf16,
                                   smem_budget=140_000) == (128, 128, 64, 4)
    assert gemm_ops_mod.smem_bytes(8192, 8192, 8192, bf16) == \
        4 * (128 * 64 + 64 * 256) * 2 + 1024 + 2 * 4 * 8
    assert gemm_ops_mod.smem_bytes(8192, 8192, 8192, bf16, stages=3) == \
        3 * (128 * 64 + 64 * 256) * 2 + 1024 + 2 * 3 * 8
    assert gemm_ops_mod.smem_bytes(256, 256, 256, f32, 64, 64) == \
        2 * (64 * 16 + 16 * 64) * 4


# ---------------------------------------------------------------------------
# tune(): records, persistence, defaults (the plain versions, on the CPU)
# ---------------------------------------------------------------------------


def test_tune_returns_valid_persisted_record(tmp_path, gemm_ops):
    args = _gemm_args(128)
    rec = tune(gemm_ops, args, store=str(tmp_path), keep=2, **CPU)
    assert isinstance(rec, TuningRecord) and not rec.cached
    assert rec.kernel == "gemm" and rec.chip == "grace-core"
    assert rec.dtype == "fp32" and rec.mode == "interpret"
    assert rec.config in gemm_ops.tuning_space.candidates(args)
    assert rec.best_time_s > 0 and rec.speedup_vs_default >= 1.0
    assert rec.best_time_s <= rec.default_time_s  # never worse
    assert rec.candidates == 3 and rec.pruned == 1
    assert rec.timed in (2, 3)  # 2 survivors, +1 if the default was pruned
    assert ArtifactStore(str(tmp_path)).entries() == {rec.fingerprint:
                                                      "gemm"}


def test_tune_same_process_store_hit_is_timing_free(tmp_path, gemm_ops):
    args = _gemm_args(128)
    first = tune(gemm_ops, args, store=str(tmp_path), keep=2, **CPU)
    n = timing_runs()
    second = tune(gemm_ops, args, store=str(tmp_path), keep=2, **CPU)
    assert second.cached and not first.cached
    assert second.config == first.config and timing_runs() == n
    third = tune(gemm_ops, args, store=str(tmp_path), keep=2, force=True,
                 **CPU)
    assert not third.cached and timing_runs() > n


def test_tune_with_invalid_default_uses_best_survivor_as_baseline(tmp_path):
    """A block table so long that the default prefill block's shared
    memory (64 query vectors, key tiles of 64) overflows the card's 232,448
    bytes: the default is never timed, the best survivor is the baseline."""
    ops = get_kernel("flash-prefill")
    ops.clear_tuned()
    nb = 50_000
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s, np.float32))  # noqa
    args = (t(1, 8, 1, 1, 16), t(1, 8, 1, 16), t(1, 8, 1, 16),
            t(2, 1, 1, 16), t(2, 1, 1, 16),
            torch.ones((1, nb), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int32))
    try:
        space = ops.tuning_space
        assert space.validate(space.default, args) is None
        rec = tune(ops, args, store=str(tmp_path), keep=2, **CPU)
        assert rec.config in space.candidates(args)
        assert rec.default_config == rec.config
        assert rec.speedup_vs_default == 1.0 and rec.timed == 2
    finally:
        ops.clear_tuned()


def test_mode_compiled_raises_on_cpu_tensors(tmp_path, gemm_ops):
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tune(gemm_ops, _gemm_args(64), store=str(tmp_path), device="cpu",
             mode="compiled", chip=hw.GRACE_CORE, repeats=1)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        gemm_ops.kernel(*_gemm_args(64))


def test_tune_dtype_axis_changes_fingerprint_and_casts(tmp_path, gemm_ops):
    args = _gemm_args(128)
    r32 = tune(gemm_ops, args, store=str(tmp_path), keep=1, **CPU)
    r16 = tune(gemm_ops, args, dtype="bf16", store=str(tmp_path), keep=1,
               **CPU)
    assert r16.dtype == "bf16" and r16.fingerprint != r32.fingerprint
    assert r16.config["tile_k"] == 64 and r32.config["tile_k"] == 16  # routes
    assert len(ArtifactStore(str(tmp_path)).entries()) == 2


def test_tune_kernels_sweep_and_jobs(tmp_path):
    kw = dict(store=str(tmp_path), keep=2, cap=2, jobs=2, device="cpu",
              mode="interpret", chip=hw.GRACE_CORE, repeats=1)
    try:
        recs = tune_kernels(["jacobi2d", "stream-triad"], **kw)
        assert [r.kernel for r in recs] == ["jacobi2d", "stream-triad"]
        assert not any(r.cached for r in recs)
        again = tune_kernels(["jacobi2d", "stream-triad"], **kw)
        assert all(r.cached for r in again)
    finally:
        for name in ("jacobi2d", "stream-triad"):
            get_kernel(name).clear_tuned()


@pytest.mark.parametrize("garbage", ["{not json", '{"version": 99}',
                                     '{"version": 1, "tuning_version": 99}'])
def test_corrupt_tuning_record_recovered(tmp_path, gemm_ops, garbage):
    args = _gemm_args(128)
    fp = tuning_fingerprint("gemm", gemm_ops.raw, args, "grace-core",
                            "fp32", gemm_ops.tuning_space)
    store = ArtifactStore(str(tmp_path))
    with open(store.path_for(fp), "w") as f:
        f.write(garbage)
    rec = tune(gemm_ops, args, store=store, keep=1, **CPU)
    assert not rec.cached and rec.fingerprint == fp
    assert store.dropped_corrupt == 1
    healed = load_record(ArtifactStore(str(tmp_path)), fp)
    assert healed is not None and healed.cached
    assert healed.config == rec.config


# ---------------------------------------------------------------------------
# KernelOps resolution, fingerprints, the ledger's hash
# ---------------------------------------------------------------------------


def _spy(monkeypatch, ops, attr):
    seen = []
    real = getattr(ops, attr)

    def spy(*args, **kw):
        seen.append(dict(kw))
        return real(*args, **kw)

    monkeypatch.setattr(ops, attr, spy)
    return seen


def test_kernelops_resolves_tuned_config_and_explicit_kwargs_win(
        tmp_path, gemm_ops, monkeypatch):
    args = _gemm_args(128)
    rec = tune(gemm_ops, args, store=str(tmp_path), keep=3, **CPU)
    assert gemm_ops.tuned_config() == rec.config
    assert "tuned[" in repr(gemm_ops) and "grace-core/fp32" in repr(gemm_ops)
    called = _spy(monkeypatch, gemm_ops, "raw")
    plain = _spy(monkeypatch, gemm_ops, "_plain")
    out = gemm_ops(*args)
    out_plain = gemm_ops.interpret(*args)
    assert called[-1] == rec.config and plain[-1] == rec.config
    gemm_ops(*args, tile_m=128, tile_n=128, tile_k=16, stages=2)
    assert called[-1] == {"tile_m": 128, "tile_n": 128, "tile_k": 16,
                          "stages": 2}
    assert torch.equal(out, out_plain)
    torch.testing.assert_close(out, gemm_ops.ref(*args), rtol=2e-5,
                               atol=2e-4)
    gemm_ops.clear_tuned()
    assert repr(gemm_ops) == "KernelOps('gemm')"
    gemm_ops(*args)
    assert called[-1] == {}


def test_kernelops_drops_config_that_does_not_fit_the_call(gemm_ops):
    # the wgmma route's default, installed for fp32: the simt route runs
    gemm_ops.set_tuned({"tile_m": 128, "tile_n": 256, "tile_k": 64,
                        "stages": 4}, chip="h100", dtype="fp32")
    args = _gemm_args(128)
    assert gemm_ops._tuned_kwargs(args, {}) == {}
    torch.testing.assert_close(gemm_ops(*args), gemm_ops.ref(*args),
                               rtol=2e-5, atol=2e-4)


def test_call_resolves_config_matching_call_dtype(gemm_ops):
    gemm_ops.set_tuned({"tile_m": 64, "tile_n": 64, "tile_k": 16,
                        "stages": 2}, chip="h100", dtype="fp32")
    gemm_ops.set_tuned({"tile_m": 128, "tile_n": 128, "tile_k": 64,
                        "stages": 4}, chip="h100", dtype="bf16")  # last
    kw = gemm_ops._tuned_kwargs(_gemm_args(128), {})
    assert kw["tile_m"] == 64  # the fp32 entry, not the active bf16 one
    kw16 = gemm_ops._tuned_kwargs(_gemm_args(128, torch.bfloat16), {})
    assert (kw16["tile_n"], kw16["tile_k"]) == (128, 64)


def test_partial_explicit_kwargs_keep_remaining_tuned_axes():
    ops = get_kernel("stream-triad")
    try:
        ops.set_tuned({"threads": 512, "vecs": 8}, chip="h100",
                      dtype="fp32")
        a, b, q = _examples()["stream-triad"]
        kw = ops._tuned_kwargs((a, b, q), {"threads": 128})
        assert kw == {"threads": 128, "vecs": 8}
    finally:
        ops.clear_tuned()


def test_outlook_finds_records_and_the_non_base_dtype(tmp_path, gemm_ops):
    args = _gemm_args(128)
    assert outlook(gemm_ops, args, hw.GRACE_CORE, dtype="fp32",
                   store=str(tmp_path))["record"] is None
    rec = tune(gemm_ops, args, store=str(tmp_path), keep=1, **CPU)
    o = outlook(gemm_ops, args, hw.GRACE_CORE, dtype="fp32",
                store=str(tmp_path))
    assert o["record"] == rec.config
    assert o["record_time_s"] == rec.best_time_s
    r16 = tune(gemm_ops, args, dtype="bf16", store=str(tmp_path), keep=1,
               **CPU)
    o16 = outlook(gemm_ops, args, hw.GRACE_CORE, dtype="bf16",
                  store=str(tmp_path))
    assert o16["record"] == r16.config
    assert o16["default_config"] == {"tile_m": 128, "tile_n": 256,
                                     "tile_k": 64, "stages": 4}


def test_load_tuned_picks_up_record_without_timing(tmp_path, gemm_ops):
    args = _gemm_args(128)
    rec = tune(gemm_ops, args, store=str(tmp_path), keep=2, **CPU)
    gemm_ops.clear_tuned()
    n = timing_runs()
    got = load_tuned(gemm_ops, args=args, store=str(tmp_path),
                     chip=hw.GRACE_CORE)
    assert got is not None and got.cached and timing_runs() == n
    assert gemm_ops.tuned_config() == rec.config
    assert load_tuned(gemm_ops, args=_gemm_args(64), store=str(tmp_path),
                      chip=hw.GRACE_CORE) is None  # another problem


def test_active_config_changes_fingerprint_and_ledger_hash(gemm_ops):
    wl = Workload(name="fp-gemm", fn=gemm_ops, args=_gemm_args(128))
    base, base_hash = workload_fingerprint(wl), tuned_state_hash()
    assert base_hash == ""
    gemm_ops.set_tuned({"tile_m": 64, "tile_n": 64, "tile_k": 16,
                        "stages": 2}, chip="h100", dtype="fp32")
    assert workload_fingerprint(wl) != base and tuned_state_hash() != ""
    gemm_ops.clear_tuned()
    assert workload_fingerprint(wl) == base and tuned_state_hash() == ""


# ---------------------------------------------------------------------------
# zero re-tuning across processes (two subprocess tests)
# ---------------------------------------------------------------------------


_LOAD_SCRIPT = """
import json
import numpy as np, torch
from repro_torch.core import hw
from repro_torch.tuning import timing_runs, tune
rng = np.random.default_rng(0)
args = tuple(torch.from_numpy(rng.standard_normal((128, 128), np.float32))
             for _ in range(2))
rec = tune("gemm", args, keep=2, repeats=1, device="cpu", mode="interpret",
           chip=hw.GRACE_CORE)
print(json.dumps({"cached": rec.cached, "timing_runs": timing_runs(),
                  "config": rec.config, "fingerprint": rec.fingerprint}))
"""


def test_second_tune_process_performs_zero_timing_runs(tmp_path, gemm_ops,
                                                        monkeypatch):
    """This process tunes into ``$REPRO_ARTIFACT_DIR``; a fresh process
    tuning the same (kernel, chip, dtype) gets the record and never
    times."""
    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path))
    first = tune(gemm_ops, _gemm_args(128), keep=2, **CPU)
    assert not first.cached
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD_SCRIPT], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": "src"}, cwd=REPO_ROOT, check=True,
        timeout=300)
    second = json.loads(proc.stdout.strip().splitlines()[-1])
    assert second["cached"] is True and second["timing_runs"] == 0
    assert second["config"] == first.config
    assert second["fingerprint"] == first.fingerprint


def test_cli_writes_tuning_json_then_times_nothing(tmp_path):
    """``--device cpu --mode interpret --cap 2 --keep 2``: every tunable
    kernel gets a record; a second process reports every record cached
    and 0 timing runs."""
    from repro_torch.tuning.__main__ import main

    store = str(tmp_path / "store")
    argv = ["--device", "cpu", "--mode", "interpret", "--cap", "2",
            "--keep", "2", "--repeats", "1", "--store-dir", store]
    try:
        assert main(argv + ["--out", str(tmp_path / "a.json")]) == 0
    finally:
        for ops in registry.KERNELS.values():
            ops.clear_tuned()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.tuning", *argv, "--out",
         str(tmp_path / "b.json")], capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": "src"}, cwd=REPO_ROOT, check=True,
        timeout=300)
    first, second = (json.loads((tmp_path / f"{x}.json").read_text())
                     for x in "ab")
    assert {r["kernel"] for r in first["records"]} == set(tunable_kernels())
    assert not any(r["cached"] for r in first["records"])
    assert first["stats"]["timing_runs"] > 0
    assert all(r["cached"] for r in second["records"])
    assert second["stats"]["timing_runs"] == 0
    assert [r["config"] for r in first["records"]] == \
        [r["config"] for r in second["records"]]
    assert "cached" in proc.stderr
