"""The port's perf trajectory ledger and decision-tree regression gate
(``repro_torch.perf``) against ``repro.perf``.

* Every test of ``tests/test_perf_gate.py``, against the port: the ledger
  is append-only; baselines resolve by policy (latest / pinned /
  rolling-median-of-K); comparison is noise-aware per metric spec; triage
  maps synthetic before/after Events deltas onto all four Fig. 8
  PerfClass outcomes with the Eq. 2 quantities that justify them; and the
  gate's exit codes.  One line of the reference's tests has no
  counterpart yet: the benchmark CLI's policy check (the port's
  benchmarks are ROADMAP 1.17.4).  The end-to-end test runs 1 and 3
  through the compiled, store-backed source, run 3 with zero recordings,
  as the reference's does.
* Parity: the same seeded metric dicts recorded in a ``repro.perf.Ledger``
  and a ``repro_torch.perf.Ledger`` give equal comparisons, gate
  verdicts, exit codes, triages and markdown (run ids aside, which are
  content addresses over each package's own env fields).
* Cross-reading: each package's ``Ledger`` reads the other's directory.
* Ledger keys: ``metrics_from_serving`` / ``metrics_from_scenario`` give
  the reference's keys and rows for every fork and combinations of forks.
* One live run: the default serve command with ``--device cpu
  --record`` through both packages records equal exact counters.
"""

import dataclasses
import itertools
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.perf as ref_perf  # noqa: E402
import repro.perf.gate as ref_gate  # noqa: E402
import repro.perf.triage as ref_triage  # noqa: E402
from repro.analysis.store import ArtifactStore as RefStore  # noqa: E402
from repro_torch.analysis import (  # noqa: E402
    ArtifactCache, analyze, analyze_events,
)
from repro_torch.analysis.store import ArtifactStore  # noqa: E402
from repro_torch.analysis.workload import get_workload  # noqa: E402
from repro_torch.core import hw  # noqa: E402
from repro_torch.core.counters import Events  # noqa: E402
from repro_torch.core.decision_tree import PerfClass  # noqa: E402
from repro_torch.core.roofline import adapted_roofline  # noqa: E402
from repro_torch.perf import (  # noqa: E402
    BenchRun,
    Ledger,
    RunEnv,
    compare_runs,
    gate_run,
    metrics_from_analysis,
    metrics_from_scenario,
    metrics_from_serving,
    metrics_from_summary,
    resolve_baseline,
    triage_regressions,
)
from repro_torch.perf.gate import export_trajectory, format_markdown  # noqa: E402
from repro_torch.perf.ledger import _SERVING_INT_METRICS  # noqa: E402
from repro_torch.perf.triage import split_key  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ENV = RunEnv(chip="grace-core", dtype="fp32", git_sha="aaaa111",
             torch_version="0", tuned_hash="", host="t")
REF_ENV = ref_perf.RunEnv(chip="grace-core", dtype="fp32", git_sha="aaaa111",
                          jax_version="0", tuned_hash="", host="t")


def _run(ledger, metrics, env=ENV):
    return ledger.record(metrics, env=env)


def _summary(wall_s=2.0, rows=13, ok=True):
    return {
        "kind": "benchmarks_summary",
        "benchmarks": [
            {"name": "fig3_vectorization", "ok": ok, "rows": rows,
             "wall_s": wall_s, "error": None}
        ],
    }


# ---------------------------------------------------------------------------
# Ledger: ingestion + append-only trajectory
# ---------------------------------------------------------------------------


def test_metrics_from_all_three_sources(tmp_path):
    ledger = Ledger(str(tmp_path))
    summary = _summary()
    tuning = {"records": [{
        "kernel": "gemm", "chip": "grace-core", "dtype": "fp32",
        "config": {"bm": 256, "bk": 128}, "best_time_s": 1e-3,
        "default_time_s": 2e-3, "speedup_vs_default": 2.0,
        "predicted_speedup": 1.5,
    }]}
    analysis = analyze("kernel/gemm", hw.GRACE_CORE)
    run = ledger.record_sources(
        summary=summary, tuning=tuning, analyses=[analysis], env=ENV
    )
    assert set(run.metrics) == {
        "bench/fig3_vectorization",
        "tuning/gemm@grace-core/fp32",
        "kernel/gemm@grace-core/fp32",
    }
    assert run.metric("bench/fig3_vectorization", "rows") == 13
    # sorted-key config token: ledger ingestion never re-derives it
    assert run.metric("tuning/gemm@grace-core/fp32", "config") == "bk=128 bm=256"
    m = run.metrics["kernel/gemm@grace-core/fp32"]
    assert m["perf_class"] == int(analysis.perf_class)
    assert m["ai"] == pytest.approx(analysis.ai)
    # everything the triage needs to re-run Fig. 8 is self-contained
    for name in ("flops", "hbm_bytes", "gather_bytes", "r_ins",
                 "vectorizable_fraction"):
        assert name in m


def _serve_report(scheduler="continuous", slot_utilization=0.9,
                  fused_steps=48, tok_s=50.0, p95=0.8):
    return {
        "kind": "serve_report",
        "arch": "gpt2-124m",
        "scheduler": scheduler,
        "stats": {
            "scheduler": scheduler,
            "requests": 6, "new_tokens": 31, "fused_steps": fused_steps,
            "busy_slot_steps": 86, "slot_steps": fused_steps * 2,
            "slot_utilization": slot_utilization, "wall_s": 0.62,
            "tok_s": tok_s, "p50_latency_s": 0.3, "p95_latency_s": p95,
        },
    }


def test_metrics_from_serving_keyed_by_arch_and_scheduler(tmp_path):
    ledger = Ledger(str(tmp_path))
    run = ledger.record_sources(serving=_serve_report(), env=ENV)
    assert set(run.metrics) == {"serve/gpt2-124m@continuous"}
    assert run.meta["sources"] == ["serving"]
    m = run.metrics["serve/gpt2-124m@continuous"]
    # everything launch.serve's stats() emits lands in the ledger row
    for name in ("tok_s", "p50_latency_s", "p95_latency_s",
                 "slot_utilization", "fused_steps", "requests", "new_tokens"):
        assert name in m, name
    assert m["slot_utilization"] == pytest.approx(0.9)
    # wave and continuous runs are distinct trajectory keys
    assert set(metrics_from_serving(_serve_report("wave"))) == {
        "serve/gpt2-124m@wave"
    }


def test_serving_regressions_gate(tmp_path):
    """Slot utilization dropping or fused steps growing regresses the
    serve path; wall-noisy tok/s movement inside tolerance does not."""
    ledger = Ledger(str(tmp_path))
    base = ledger.record_sources(serving=_serve_report(), env=ENV)
    worse = ledger.record_sources(
        serving=_serve_report(slot_utilization=0.7, fused_steps=60,
                              tok_s=47.0), env=ENV,
    )
    cmp_ = compare_runs(base, worse)
    regressed = {(r.key, r.metric) for r in cmp_.regressions}
    assert ("serve/gpt2-124m@continuous", "slot_utilization") in regressed
    assert ("serve/gpt2-124m@continuous", "fused_steps") in regressed
    assert ("serve/gpt2-124m@continuous", "tok_s") not in regressed  # -6%, noisy
    result = gate_run(worse, ledger, policy="latest")
    assert not result.ok and result.exit_code == 1
    # a same-metrics re-record passes
    again = ledger.record_sources(serving=_serve_report(), env=ENV)
    assert gate_run(again, ledger, policy="pinned:" + base.run_id[:10]).ok


def test_summary_env_stamp_is_honored(tmp_path):
    summary = {**_summary(), "env": dataclasses.asdict(
        dataclasses.replace(ENV, git_sha="stamped99"))}
    run = Ledger(str(tmp_path)).record_sources(summary=summary)
    assert run.env.git_sha == "stamped99"  # never re-derived


def test_ledger_appends_never_rewrites(tmp_path):
    ledger = Ledger(str(tmp_path))
    r1 = _run(ledger, metrics_from_summary(_summary()))
    r2 = _run(ledger, metrics_from_summary(_summary()))  # identical payload
    assert r1.run_id != r2.run_id  # timestamp+seq are part of the address
    assert [r.seq for r in ledger.runs()] == [1, 2]
    # the first entry's bytes are untouched by the second record
    p1 = ledger.store.path_for(r1.run_id)
    with open(p1) as f:
        assert json.load(f)["run"]["run_id"] == r1.run_id


def test_ledger_series_filter_and_lookup(tmp_path):
    ledger = Ledger(str(tmp_path))
    r1 = _run(ledger, metrics_from_summary(_summary()))
    r2 = _run(ledger, metrics_from_summary(_summary()),
              env=dataclasses.replace(ENV, dtype="bf16"))
    assert ledger.series() == ["grace-core/bf16", "grace-core/fp32"]
    assert [r.run_id for r in ledger.runs("grace-core/fp32")] == [r1.run_id]
    assert ledger.get(r1.run_id[:10]).run_id == r1.run_id  # prefix lookup
    assert ledger.latest("grace-core/bf16").run_id == r2.run_id


def test_ledger_refuses_empty_and_skips_corrupt(tmp_path):
    ledger = Ledger(str(tmp_path))
    with pytest.raises(ValueError):
        ledger.record({})
    r1 = _run(ledger, metrics_from_summary(_summary()))
    (tmp_path / "zz.json").write_text("{not json")
    assert [r.run_id for r in ledger.runs()] == [r1.run_id]  # skip, not raise
    assert (tmp_path / "zz.json").exists()  # enumeration never deletes


# ---------------------------------------------------------------------------
# Baseline policies
# ---------------------------------------------------------------------------


def test_baseline_latest_excludes_run_under_test(tmp_path):
    ledger = Ledger(str(tmp_path))
    r1 = _run(ledger, metrics_from_summary(_summary(wall_s=1.0)))
    r2 = _run(ledger, metrics_from_summary(_summary(wall_s=2.0)))
    assert resolve_baseline(ledger, "latest").run_id == r2.run_id
    assert resolve_baseline(
        ledger, "latest", exclude=(r2.run_id,)
    ).run_id == r1.run_id


def test_baseline_pinned_by_run_id_and_git_sha(tmp_path):
    ledger = Ledger(str(tmp_path))
    r1 = _run(ledger, metrics_from_summary(_summary()),
              env=dataclasses.replace(ENV, git_sha="feedbeef1234"))
    _run(ledger, metrics_from_summary(_summary()))
    assert resolve_baseline(ledger, f"pinned:{r1.run_id[:8]}").run_id == r1.run_id
    assert resolve_baseline(ledger, "pinned:feedbeef").run_id == r1.run_id
    assert resolve_baseline(ledger, "pinned:nope") is None


def test_baseline_median_absorbs_an_outlier(tmp_path):
    ledger = Ledger(str(tmp_path))
    for wall in (1.0, 1.1, 30.0):  # one noisy spike
        _run(ledger, metrics_from_summary(_summary(wall_s=wall)))
    base = resolve_baseline(ledger, "median:3")
    assert base.metric("bench/fig3_vectorization", "wall_s") == 1.1
    assert base.metric("bench/fig3_vectorization", "rows") == 13
    assert base.meta["synthetic"] == "median:3"


def test_baseline_unknown_policy_raises(tmp_path):
    ledger = Ledger(str(tmp_path))
    _run(ledger, metrics_from_summary(_summary()))
    with pytest.raises(ValueError):
        resolve_baseline(ledger, "newest")
    with pytest.raises(ValueError):
        resolve_baseline(ledger, "median:x")


# ---------------------------------------------------------------------------
# Noise-aware comparison
# ---------------------------------------------------------------------------


def test_wall_noise_within_tolerance_is_not_a_regression(tmp_path):
    ledger = Ledger(str(tmp_path))
    base = _run(ledger, metrics_from_summary(_summary(wall_s=1.00)))
    ok = _run(ledger, metrics_from_summary(_summary(wall_s=1.05)))  # +5% < 10%
    bad = _run(ledger, metrics_from_summary(_summary(wall_s=1.50)))  # +50%
    assert compare_runs(base, ok).ok
    cmp_bad = compare_runs(base, bad)
    assert [r.metric for r in cmp_bad.regressions] == ["wall_s"]
    # the CI knob: scaling noisy tolerances absorbs shared-runner noise
    assert compare_runs(base, bad, wall_tol_scale=6.0).ok


def test_pass_fail_and_rows_are_deterministic_gates(tmp_path):
    ledger = Ledger(str(tmp_path))
    base = _run(ledger, metrics_from_summary(_summary()))
    broke = _run(ledger, metrics_from_summary(_summary(ok=False, rows=0)))
    got = {r.metric for r in compare_runs(base, broke).regressions}
    assert got == {"ok", "rows"}


def test_zero_baseline_movement_is_informational_not_astronomical(tmp_path):
    """A 0.000-rounded baseline wall time must not turn epsilon-nonzero
    into a +1e29% regression; the delta is reported, never gated, and its
    JSON form stays strict (no Infinity)."""
    ledger = Ledger(str(tmp_path))
    base = _run(ledger, {"bench/x": {"wall_s": 0.0}})
    run = _run(ledger, {"bench/x": {"wall_s": 0.001}})
    cmp_ = compare_runs(base, run)
    assert cmp_.ok
    (d,) = cmp_.deltas
    assert d.rel_delta == float("inf") and not d.regressed
    assert json.loads(json.dumps(cmp_.to_dict()))["deltas"][0]["rel_delta"] is None


def test_record_sources_propagates_summary_failure_count(tmp_path):
    """``record --summary`` of an aborted run must mark the run unhealthy,
    or baseline resolution would anchor on its truncated walls."""
    ledger = Ledger(str(tmp_path))
    aborted = {**_summary(wall_s=0.1, ok=False), "failed": 1}
    bad = ledger.record_sources(summary=aborted, env=ENV)
    assert bad.meta["failed"] == 1
    assert resolve_baseline(ledger, "latest", exclude=()) is None  # filtered


def test_disjoint_keys_report_but_never_gate(tmp_path):
    ledger = Ledger(str(tmp_path))
    base = _run(ledger, {"bench/a": {"wall_s": 1.0}})
    run = _run(ledger, {"bench/b": {"wall_s": 9.0}})
    cmp_ = compare_runs(base, run)
    assert cmp_.ok
    assert cmp_.new_keys == ["bench/b"] and cmp_.missing_keys == ["bench/a"]


# ---------------------------------------------------------------------------
# Golden triage: synthetic Events deltas -> all four PerfClass outcomes
# ---------------------------------------------------------------------------


def _point(name, flops, bytes_, gather=0.0, nonvec=0.0):
    """One trajectory point derived from synthetic artifact Events."""
    ev = Events()
    ev.flops = flops
    ev.bytes_accessed = bytes_
    ev.hbm_read_bytes = bytes_ / 2
    ev.gather_bytes = gather
    ev.nonvec_flops = nonvec
    return analyze_events(name, ev, hw.GRACE_CORE, dtype="fp32")


# before: a healthy compute-bound kernel (Class 4, AI = 1000)
_BEFORE = ("k", 1e9, 1e6)
# after-deltas chosen to land on each Fig. 8 leaf
_GOLDEN = [
    # vectorizable share collapses (threading-runtime/serial growth): Class 1
    (("k", 1e9, 1e6, 0.0, 0.95e9), PerfClass.NOT_VECTORIZED),
    # streaming traffic blows up, AI falls left of the knee: Class 2
    (("k", 1e9, 4e9), PerfClass.MEMORY_BANDWIDTH_BOUND),
    # same blow-up but pointer-chasing (gather share > ELEN/line): Class 3
    (("k", 1e9, 4e9, 1.5e9), PerfClass.MEMORY_LATENCY_BOUND),
    # stays compute-bound but does 2x the FLOPs (redundant work): Class 4
    (("k", 2e9, 1e6), PerfClass.SPEEDUP),
]


@pytest.mark.parametrize("after_args,expect_class", _GOLDEN)
def test_triage_maps_events_deltas_onto_each_perf_class(
    tmp_path, after_args, expect_class
):
    ledger = Ledger(str(tmp_path))
    before = _point(*_BEFORE)
    assert before.perf_class == PerfClass.SPEEDUP  # the healthy baseline
    after = _point(*after_args)
    assert after.perf_class == expect_class  # the synthetic delta lands
    base = _run(ledger, metrics_from_analysis([before]))
    run = _run(ledger, metrics_from_analysis([after]))
    cmp_ = compare_runs(base, run)
    assert not cmp_.ok
    triages = triage_regressions(cmp_, base, run, tuning_store=None)
    assert len(triages) == 1
    t = triages[0]
    # triage re-derives the same classes the pipeline computed
    assert t.class_before == PerfClass.SPEEDUP
    assert t.class_after == expect_class
    # ... and justifies them with the Eq. 2 quantities
    rl = adapted_roofline(hw.GRACE_CORE, "fp32")
    assert t.ai_irv == pytest.approx(rl.ai_irv)
    assert t.ai_irr == pytest.approx(rl.ai_irr)
    assert "AI" in t.narrative and "AI_IRV" in t.narrative
    if expect_class != PerfClass.SPEEDUP:
        assert f"Class {int(expect_class)}" in t.narrative
        assert "slipped from Class 4" in t.narrative


def test_triage_flags_stale_tuning_record(tmp_path):
    """A run recorded under one config while the tuning store's best is
    another must name the stale TuningRecord as a suspect.  The records
    are written by the reference's ``save_record`` (the port's tuner is
    ROADMAP 1.17.3) and read through the port's store."""
    from repro.tuning import TuningRecord, save_record

    store = RefStore(str(tmp_path / "tuning"))
    save_record(store, TuningRecord(
        kernel="gemm", chip="grace-core", dtype="fp32", fingerprint="ff" * 16,
        config={"bm": 256, "bn": 256, "bk": 256},
        default_config={"bm": 128, "bn": 128, "bk": 128},
        best_time_s=1e-3, default_time_s=2e-3,
    ))
    ledger = Ledger(str(tmp_path / "perf"))
    before = metrics_from_analysis([_point("kernel/gemm", 1e9, 1e6)])
    after = metrics_from_analysis([_point("kernel/gemm", 1e9, 4e9)])
    after["kernel/gemm@grace-core/fp32"]["config"] = "bk=128 bm=128 bn=128"
    base, run = _run(ledger, before), _run(ledger, after)
    cmp_ = compare_runs(base, run)
    port_store = ArtifactStore(str(tmp_path / "tuning"))
    for tuning_store in (str(tmp_path / "tuning"), port_store):
        (t,) = triage_regressions(cmp_, base, run, tuning_store=tuning_store)
        assert any("stale TuningRecord" in s for s in t.suspects)

    # multiple persisted records per (kernel, chip, dtype) are normal
    # (capped CI spaces, other problem shapes): a run whose config matches
    # ANY of them is NOT stale — no false re-tune chase
    save_record(store, TuningRecord(
        kernel="gemm", chip="grace-core", dtype="fp32", fingerprint="ee" * 16,
        config={"bm": 128, "bn": 128, "bk": 128},
        default_config={"bm": 128, "bn": 128, "bk": 128},
        best_time_s=1e-3, default_time_s=1e-3,
    ))
    (t2,) = triage_regressions(cmp_, base, run, tuning_store=port_store)
    assert not any("stale TuningRecord" in s for s in t2.suspects)


def test_triage_wall_only_regression_suspects_noise(tmp_path):
    ledger = Ledger(str(tmp_path))
    base = _run(ledger, {"bench/x": {"wall_s": 1.0, "rows": 5}})
    run = _run(ledger, {"bench/x": {"wall_s": 2.0, "rows": 5}})
    cmp_ = compare_runs(base, run)
    (t,) = triage_regressions(cmp_, base, run, tuning_store=None)
    assert t.class_before is None  # no counters to re-classify
    assert any("noise" in s for s in t.suspects)


def test_split_key():
    assert split_key("kernel/gemm@grace-core/fp32") == (
        "kernel/gemm", "grace-core", "fp32")
    assert split_key("bench/fig3") == ("bench/fig3", None, None)


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------


def test_gate_first_run_passes_trivially(tmp_path):
    ledger = Ledger(str(tmp_path))
    r1 = _run(ledger, metrics_from_summary(_summary()))
    g = gate_run(r1, ledger)
    assert g.ok and g.exit_code == 0 and g.baseline_id is None
    assert "no baseline" in g.note


def test_gate_latest_walks_back_to_a_comparable_run(tmp_path):
    """A heterogeneous ledger (benchmark runs + service reports) must not
    turn the gate vacuous: 'latest' falls back past a disjoint record to
    the newest run that shares metrics with the run under test."""
    ledger = Ledger(str(tmp_path))
    _run(ledger, metrics_from_summary(_summary(wall_s=1.0)))  # comparable
    _run(ledger, metrics_from_analysis([_point("k", 1e9, 1e6)]))  # disjoint
    slow = _run(ledger, metrics_from_summary(_summary(wall_s=9.0)))
    g = gate_run(slow, ledger, tuning_store=None)
    assert not g.ok  # the +800% wall regression was NOT masked
    assert "fell back" in g.note


def test_gate_with_fully_disjoint_baseline_is_loudly_vacuous(tmp_path):
    ledger = Ledger(str(tmp_path))
    _run(ledger, metrics_from_analysis([_point("k", 1e9, 1e6)]))
    other = _run(ledger, {"bench/other": {"wall_s": 1.0}})
    g = gate_run(other, ledger, tuning_store=None)
    assert g.ok and "VACUOUS" in g.note and "VACUOUS" in g.describe()


def test_failed_runs_never_become_latest_or_median_baselines(tmp_path):
    """An aborted benchmark run (meta['failed']) records a truncated wall
    time; anchoring on it would fail the next healthy run spuriously."""
    ledger = Ledger(str(tmp_path))
    good = _run(ledger, metrics_from_summary(_summary(wall_s=5.0)))
    ledger.record(metrics_from_summary(_summary(wall_s=0.1, ok=False)),
                  env=ENV, meta={"failed": 1})
    healthy = _run(ledger, metrics_from_summary(_summary(wall_s=5.2)))
    assert resolve_baseline(
        ledger, "latest", exclude=(healthy.run_id,)
    ).run_id == good.run_id
    base = resolve_baseline(ledger, "median:3", exclude=(healthy.run_id,))
    assert base.metric("bench/fig3_vectorization", "wall_s") == 5.0
    assert gate_run(healthy, ledger, tuning_store=None).ok
    # pinned: stays the operator's explicit (unfiltered) choice
    runs = ledger.runs()
    assert resolve_baseline(
        ledger, f"pinned:{runs[1].run_id[:12]}"
    ).run_id == runs[1].run_id


def test_trajectory_export_disambiguates_seq_collisions(tmp_path):
    """Two concurrent recorders landing on one seq both keep an export."""
    ledger = Ledger(str(tmp_path / "perf"))
    r1 = _run(ledger, metrics_from_summary(_summary()))
    clash = dataclasses.replace(r1, run_id="ff" * 16, timestamp=r1.timestamp + 1)
    ledger.store.put_json(clash.run_id, {
        "kind": "perf_run", "perf_version": 1, "run": clash.to_dict(),
    })
    paths = export_trajectory(ledger, str(tmp_path / "export"))
    names = [os.path.basename(p) for p in paths]
    assert names == ["BENCH_1.json", "BENCH_1_ffffffff.json"]


def test_gate_is_series_scoped(tmp_path):
    """A bf16 run never gates against an fp32 baseline (the trajectory is
    keyed by (chip, dtype))."""
    ledger = Ledger(str(tmp_path))
    _run(ledger, metrics_from_summary(_summary(wall_s=1.0)))
    slow16 = _run(ledger, metrics_from_summary(_summary(wall_s=9.0)),
                  env=dataclasses.replace(ENV, dtype="bf16"))
    assert gate_run(slow16, ledger).ok  # first bf16 point: nothing to regress


def test_gate_unresolved_pin_fails_instead_of_going_green(tmp_path):
    """A typo'd/garbage-collected pin must be an error, not a trivial pass
    — otherwise the gate silently checks nothing forever."""
    ledger = Ledger(str(tmp_path))
    r1 = _run(ledger, metrics_from_summary(_summary()))
    g = gate_run(r1, ledger, policy="pinned:deadbee")
    assert not g.ok and g.exit_code == 1
    assert "did not resolve" in g.note and "FAIL" in g.describe()


def test_malformed_policy_fails_fast(tmp_path):
    from repro_torch.perf.baseline import validate_policy

    for bad in ("median:x", "median:0", "pinned:", "newest"):
        with pytest.raises(ValueError):
            validate_policy(bad)
    # the perf CLI rejects it at argparse time (exit 2), ledger untouched
    from repro_torch.perf.__main__ import main

    with pytest.raises(SystemExit) as exc:
        main(["--store-dir", str(tmp_path), "gate", "--baseline", "median:x"])
    assert exc.value.code == 2
    assert os.listdir(tmp_path) == []


def test_vanished_metric_is_reported_in_comparison_and_note(tmp_path):
    ledger = Ledger(str(tmp_path))
    base = _run(ledger, {"bench/x": {"wall_s": 1.0, "rows": 5}})
    run = _run(ledger, {"bench/x": {"rows": 5, "extra": 1.0}})
    cmp_ = compare_runs(base, run)
    assert cmp_.missing_metrics == ["bench/x.wall_s"]
    assert cmp_.new_metrics == ["bench/x.extra"]
    g = gate_run(run, ledger, tuning_store=None)
    assert g.ok and "metrics vanished" in g.note  # loud, but not a verdict flip


def test_gate_result_round_trips_to_json(tmp_path):
    ledger = Ledger(str(tmp_path))
    base = _run(ledger, metrics_from_analysis([_point("k", 1e9, 1e6)]))
    run = _run(ledger, metrics_from_analysis([_point("k", 1e9, 4e9)]))
    g = gate_run(run, ledger, tuning_store=None)
    payload = json.loads(json.dumps(g.to_dict()))
    assert payload["ok"] is False and payload["exit_code"] == 1
    assert payload["baseline_id"] == base.run_id
    assert payload["triage"][0]["class_transition"].startswith("Class 4")


def test_markdown_and_trajectory_export(tmp_path):
    ledger = Ledger(str(tmp_path / "perf"))
    _run(ledger, metrics_from_summary(_summary(wall_s=1.0)))
    r2 = _run(ledger, metrics_from_summary(_summary(wall_s=5.0)))
    g = gate_run(r2, ledger, tuning_store=None)
    md = format_markdown(ledger, gate=g)
    assert "# Performance trajectory" in md and "FAIL" in md
    assert r2.run_id[:12] in md
    out = str(tmp_path / "export")
    paths = export_trajectory(ledger, out)
    assert [os.path.basename(p) for p in paths] == ["BENCH_1.json", "BENCH_2.json"]
    point = json.load(open(paths[1]))
    assert point["kind"] == "perf_trajectory_point"
    assert BenchRun.from_dict(point["run"]).run_id == r2.run_id


# ---------------------------------------------------------------------------
# End-to-end gate contract
# ---------------------------------------------------------------------------


def test_end_to_end_gate_contract(tmp_path):
    """record -> perturb a kernel's traffic -> gate exits non-zero naming
    the PerfClass transition with AI vs AI_IRV; the unperturbed re-run
    exits zero AND records nothing (store-backed), as the reference's
    runs 1 and 3 do through the compiled source."""
    events_store = str(tmp_path / "events")
    ledger = Ledger(str(tmp_path / "perf"))
    wl = get_workload("kernel/gemm")

    # -- run 1: the healthy baseline, recorded through a persistent store
    cache1 = ArtifactCache(store=events_store)
    a1 = analyze(wl, hw.GRACE_CORE, source="compiled", cache=cache1)
    assert cache1.compiles == 1
    run1 = ledger.record(metrics_from_analysis([a1]), env=ENV)
    assert gate_run(run1, ledger, tuning_store=None).ok  # nothing to regress

    # -- run 2: a perturbed config re-streams operands (the stale-tile
    # failure mode): same workload name/chip/dtype, 64x the HBM traffic
    bad = dataclasses.replace(
        wl, flops=a1.events.flops, hbm_bytes=a1.events.bytes_accessed * 64,
    )
    a2 = analyze(bad, hw.GRACE_CORE, source="analytic")
    run2 = ledger.record(metrics_from_analysis([a2]), env=ENV)
    g2 = gate_run(run2, ledger, tuning_store=None)
    assert not g2.ok and g2.exit_code != 0
    (t,) = [t for t in g2.triages if t.key.startswith("kernel/gemm")]
    rl = adapted_roofline(hw.GRACE_CORE, "fp32")
    assert t.class_before == PerfClass.SPEEDUP
    assert t.class_after in (PerfClass.MEMORY_BANDWIDTH_BOUND,
                             PerfClass.MEMORY_LATENCY_BOUND)
    # the Eq. 2 justification: AI crossed the scalar knee (the Fig. 8
    # stage-2 threshold), and both inflection points are reported
    assert t.ai_after < rl.ai_irr <= t.ai_before
    assert t.ai_irv == pytest.approx(rl.ai_irv)
    assert "AI_IRV" in t.narrative and "Class" in t.narrative

    # -- run 3: unperturbed re-run in a fresh cache (= a fresh process):
    # store hit, ZERO recordings, and the gate against the healthy
    # baseline exits zero
    cache2 = ArtifactCache(store=events_store)
    a3 = analyze(wl, hw.GRACE_CORE, source="compiled", cache=cache2)
    assert cache2.compiles == 0 and cache2.store_hits == 1
    run3 = ledger.record(metrics_from_analysis([a3]), env=ENV)
    g3 = gate_run(run3, ledger, policy=f"pinned:{run1.run_id[:12]}",
                  tuning_store=None)
    assert g3.ok and g3.exit_code == 0


# ---------------------------------------------------------------------------
# Cross-process: a second `record` run appends, never rewrites
# ---------------------------------------------------------------------------


def test_second_record_process_appends_never_rewrites(tmp_path):
    summary_path = tmp_path / "summary.json"
    summary_path.write_text(json.dumps({**_summary(), "env": ENV.to_dict()}))
    env = {**os.environ, "PYTHONPATH": "src",
           "REPRO_ARTIFACT_DIR": str(tmp_path / "artifacts")}
    perf_dir = str(tmp_path / "artifacts" / "torch" / "perf")
    for i in range(2):
        subprocess.run(
            [sys.executable, "-m", "repro_torch.perf", "record",
             "--summary", str(summary_path)],
            capture_output=True, text=True, env=env, cwd=REPO_ROOT,
            check=True, timeout=120,
        )
        if i == 0:
            ledger = Ledger(perf_dir)
            (first,) = ledger.runs()
            first_path = ledger.store.path_for(first.run_id)
            first_bytes = open(first_path, "rb").read()
    runs = Ledger(perf_dir).runs()
    assert [r.seq for r in runs] == [1, 2]
    assert runs[0].run_id != runs[1].run_id
    # byte-identical first entry: append-only held across processes
    assert open(first_path, "rb").read() == first_bytes


def test_gate_cli_exit_codes(tmp_path):
    """``python -m repro_torch.perf gate`` exits 0 on pass, 1 on
    regression."""
    from repro_torch.perf.__main__ import main

    root = str(tmp_path / "perf")
    ledger = Ledger(root)
    _run(ledger, metrics_from_analysis([_point("k", 1e9, 1e6)]))
    assert main(["--store-dir", root, "gate", "--no-tuning-store"]) == 0
    _run(ledger, metrics_from_analysis([_point("k", 1e9, 4e9)]))
    out = str(tmp_path / "gate.json")
    assert main(["--store-dir", root, "gate", "--no-tuning-store",
                 "--out", out]) == 1
    payload = json.load(open(out))
    assert payload["ok"] is False
    assert payload["triage"][0]["class_transition"] is not None


# ---------------------------------------------------------------------------
# chunked-prefill serving trajectories
# ---------------------------------------------------------------------------


def _chunked_serve_report(chunk=8, ttft_p95_steps=30.0, ttft_p50_steps=12.0,
                          fused_steps=40):
    rep = _serve_report(fused_steps=fused_steps)
    rep["prefill_chunk"] = chunk
    rep["prefill_budget"] = chunk
    rep["stats"].update({
        "prefill_chunk": chunk, "prefill_budget": chunk,
        "ttft_p50_s": 0.1, "ttft_p95_s": 0.2,
        "ttft_p50_steps": ttft_p50_steps,
        "ttft_p95_steps": ttft_p95_steps,
    })
    return rep


def test_metrics_from_serving_chunked_variant_key(tmp_path):
    """prefill_chunk > 1 forks the trajectory key: the chunked and
    token-by-token runs must never share a baseline."""
    m = metrics_from_serving(_chunked_serve_report(chunk=8))
    (key, row), = m.items()
    assert key == "serve/gpt2-124m@continuous+prefill8"
    assert row["prefill_chunk"] == 8 and isinstance(row["prefill_chunk"], int)
    assert row["ttft_p95_steps"] == 30.0
    # chunk 1 (or absent) keeps the legacy key byte-for-byte
    plain = _serve_report()
    assert set(metrics_from_serving(plain)) == {"serve/gpt2-124m@continuous"}
    # both variants can land in one run as disjoint trajectories
    run = Ledger(str(tmp_path)).record(
        {**metrics_from_serving(plain),
         **metrics_from_serving(_chunked_serve_report())}, env=ENV)
    assert len(run.metrics) == 2


def test_ttft_steps_regression_gates_exactly(tmp_path):
    """The step-clock TTFT is deterministic given the trace, so ANY growth
    on the chunked trajectory regresses — while the noisy wall TTFT needs
    its 20% headroom."""
    ledger = Ledger(str(tmp_path))
    base = ledger.record(
        metrics_from_serving(_chunked_serve_report(ttft_p95_steps=30.0)),
        env=ENV)
    worse = ledger.record(
        metrics_from_serving(_chunked_serve_report(ttft_p95_steps=31.0)),
        env=ENV)
    cmp_ = compare_runs(base, worse)
    key = "serve/gpt2-124m@continuous+prefill8"
    assert (key, "ttft_p95_steps") in {
        (r.key, r.metric) for r in cmp_.regressions}
    assert not gate_run(worse, ledger, policy="latest").ok
    # improvement direction never trips
    better = ledger.record(
        metrics_from_serving(_chunked_serve_report(ttft_p95_steps=29.0,
                                                   fused_steps=39)),
        env=ENV)
    assert gate_run(better, ledger,
                    policy="pinned:" + base.run_id[:10]).ok


def test_ttft_regression_triages_to_scheduling_not_noise(tmp_path):
    """Triage on a chunked-serve TTFT regression names the scheduler
    counters as the suspect — never 'machine noise', which is the verdict
    reserved for wall-only movement."""
    ledger = Ledger(str(tmp_path))
    base = _run(ledger, metrics_from_serving(_chunked_serve_report()))
    worse = _run(ledger, metrics_from_serving(
        _chunked_serve_report(ttft_p95_steps=65.0, ttft_p50_steps=30.0,
                              fused_steps=48)))
    cmp_ = compare_runs(base, worse)
    assert not cmp_.ok
    (t,) = triage_regressions(cmp_, base, worse, tuning_store=None)
    assert t.key == "serve/gpt2-124m@continuous+prefill8"
    assert {"ttft_p95_steps", "ttft_p50_steps", "fused_steps"} <= set(
        t.metrics)
    assert any("admission/chunking/budget" in s for s in t.suspects)
    assert not any("wall-time regression" in s for s in t.suspects)
    assert "ttft_p95_steps" in t.narrative


def test_prefill_chunk_drop_regresses(tmp_path):
    """A run that silently serves with a narrower chunk than its baseline
    (same trajectory key, e.g. a config override bug) regresses on the
    exact prefill_chunk counter."""
    ledger = Ledger(str(tmp_path))
    base = _run(ledger, {"serve/gpt2-124m@continuous+prefill8": {
        "prefill_chunk": 8, "fused_steps": 40}})
    worse = _run(ledger, {"serve/gpt2-124m@continuous+prefill8": {
        "prefill_chunk": 4, "fused_steps": 40}})
    cmp_ = compare_runs(base, worse)
    assert [(r.key, r.metric) for r in cmp_.regressions] == [
        ("serve/gpt2-124m@continuous+prefill8", "prefill_chunk")]


# ---------------------------------------------------------------------------
# Parity with the reference: the same runs in both packages' ledgers
# ---------------------------------------------------------------------------


#: the analysis points of the parity trajectories: (flops, bytes, gather,
#: nonvec) around a healthy Class 4 kernel, one per Fig. 8 leaf
_PARITY_POINTS = [(1e9, 1e6, 0.0, 0.0), (1e9, 1e6, 0.0, 0.95e9),
                  (1e9, 4e9, 0.0, 0.0), (1e9, 4e9, 1.5e9, 0.0),
                  (2e9, 1e6, 0.0, 0.0)]


def _parity_metrics(seed, n_runs=6):
    """``n_runs`` metric dicts drawn with numpy from ``seed``: a serve row
    (noisy timings, scheduler counters that now and then move), a chunked
    serve row, a kernel row on one of the Fig. 8 leaves, and a benchmark
    row whose pass/fail may flip."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_runs):
        steps = 48 + int(rng.integers(0, 3)) * int(rng.random() < 0.4)
        serve = _serve_report(
            slot_utilization=float(0.9 - 0.1 * (rng.random() < 0.3)),
            fused_steps=steps, tok_s=float(50.0 * rng.uniform(0.7, 1.3)),
            p95=float(0.8 * rng.uniform(0.8, 1.4)))
        chunked = _chunked_serve_report(
            ttft_p95_steps=float(30 + rng.integers(0, 2)),
            fused_steps=40 + int(rng.integers(0, 2)))
        point = _PARITY_POINTS[0 if i == 0 else
                               int(rng.integers(0, len(_PARITY_POINTS)))]
        flops, bytes_, gather, nonvec = point
        kernel = metrics_from_analysis([_point(
            "kernel/gemm", flops * float(rng.uniform(0.99, 1.01)), bytes_,
            gather, nonvec)])
        m = {**metrics_from_serving(serve), **metrics_from_serving(chunked),
             **kernel,
             **metrics_from_summary(_summary(
                 wall_s=float(rng.uniform(1.0, 1.6)),
                 rows=13 - int(rng.random() < 0.2),
                 ok=bool(rng.random() < 0.85)))}
        out.append(m)
    return out


def _both_ledgers(tmp_path, seed):
    port = Ledger(str(tmp_path / "port"))
    ref = ref_perf.Ledger(str(tmp_path / "ref"))
    for m in _parity_metrics(seed):
        port.record(m, env=ENV)
        ref.record(m, env=REF_ENV)
    return port, ref


def _ids_to_seqs(text, *ledgers):
    """``text`` with every run id (and 12- or 10-character prefix of one)
    of ``ledgers`` replaced by ``run<seq>``: run ids are content addresses
    over each package's own env fields, so they differ across packages."""
    for ledger in ledgers:
        for r in ledger.runs():
            text = re.sub(re.escape(r.run_id[:10]) + r"[0-9a-f]*",
                          f"run{r.seq}", text)
    return text


def _canon(obj, *ledgers):
    return json.loads(_ids_to_seqs(json.dumps(obj, sort_keys=True), *ledgers))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_parity_with_the_reference_gate(tmp_path, seed):
    """For every run of a seeded trajectory and every policy: the same
    baseline, comparison, gate verdict, exit code, regressions and triages
    (class transitions, AI quantities, suspects, narratives), and the same
    markdown, as the reference's on the same runs."""
    port, ref = _both_ledgers(tmp_path, seed)
    p_runs, r_runs = port.runs(), ref.runs()
    assert [r.seq for r in p_runs] == [r.seq for r in r_runs]
    verdicts = []
    for p_run, r_run in zip(p_runs, r_runs):
        assert p_run.metrics == r_run.metrics
        for policy in ("latest", "median:3", "pinned:aaaa",
                       f"pinned:{p_runs[0].run_id[:12]}"):
            r_policy = (policy if p_runs[0].run_id[:12] not in policy
                        else f"pinned:{r_runs[0].run_id[:12]}")
            pb = resolve_baseline(port, policy, series=p_run.env.series_key(),
                                  exclude=(p_run.run_id,))
            rb = ref_perf.resolve_baseline(
                ref, r_policy, series=r_run.env.series_key(),
                exclude=(r_run.run_id,))
            assert (pb is None) == (rb is None)
            if pb is not None:
                assert pb.metrics == rb.metrics
                assert _canon(compare_runs(pb, p_run).to_dict(), port, ref) \
                    == _canon(ref_perf.compare_runs(rb, r_run).to_dict(),
                              port, ref)
            pg = gate_run(p_run, port, policy=policy, tuning_store=None)
            rg = ref_perf.gate_run(r_run, ref, policy=r_policy,
                                   tuning_store=None)
            assert (pg.ok, pg.exit_code) == (rg.ok, rg.exit_code)
            verdicts.append(pg.ok)
            pd, rd = pg.to_dict(), rg.to_dict()
            assert _canon(pd, port, ref) == _canon(rd, port, ref)
            assert [t.class_transition for t in pg.triages] == [
                t.class_transition for t in rg.triages]
            assert [t.suspects for t in pg.triages] == [
                t.suspects for t in rg.triages]
            assert _ids_to_seqs(pg.describe(), port, ref) == \
                _ids_to_seqs(rg.describe(), port, ref)
        md = format_markdown(port, gate=pg)
        rmd = ref_gate.format_markdown(ref, gate=rg)
        assert _ids_to_seqs(md, port, ref) == _ids_to_seqs(rmd, port, ref)
    assert not all(verdicts)  # the trajectory does regress somewhere


@pytest.mark.parametrize("seed", [0, 1])
def test_parity_triage_with_a_changed_sha(tmp_path, seed):
    """Triage on regressions between runs recorded at two git SHAs (and
    two tuned hashes): the same classes, AI quantities and suspects,
    ``code changed`` and ``active tuned-config set changed`` among them."""
    metrics = _parity_metrics(seed, n_runs=2)
    metrics[1]["kernel/gemm@grace-core/fp32"] = metrics_from_analysis(
        [_point("kernel/gemm", 1e9, 4e9)])["kernel/gemm@grace-core/fp32"]
    port = Ledger(str(tmp_path / "port"))
    ref = ref_perf.Ledger(str(tmp_path / "ref"))
    pruns = [port.record(metrics[0], env=ENV),
             port.record(metrics[1], env=dataclasses.replace(
                 ENV, git_sha="bbbb222", tuned_hash="abc"))]
    rruns = [ref.record(metrics[0], env=REF_ENV),
             ref.record(metrics[1], env=dataclasses.replace(
                 REF_ENV, git_sha="bbbb222", tuned_hash="abc"))]
    pc = compare_runs(*pruns)
    rc = ref_perf.compare_runs(*rruns)
    pt = triage_regressions(pc, *pruns, tuning_store=None)
    rt = ref_triage.triage_regressions(rc, *rruns, tuning_store=None)
    assert [t.to_dict() for t in pt] == [t.to_dict() for t in rt]
    (kt,) = [t for t in pt if t.key.startswith("kernel/")]
    assert kt.class_transition.startswith("Class 4")
    assert any(s.startswith("code changed: aaaa111 -> bbbb222")
               for s in kt.suspects)
    assert any("tuned-config set changed" in s for s in kt.suspects)


# ---------------------------------------------------------------------------
# Cross-reading: each package's Ledger reads the other's directory
# ---------------------------------------------------------------------------


def _same_runs(a, b):
    assert [(r.run_id, r.seq, r.timestamp, r.metrics, r.meta) for r in a] \
        == [(r.run_id, r.seq, r.timestamp, r.metrics, r.meta) for r in b]


def test_port_ledger_reads_the_reference_directory(tmp_path):
    ref = ref_perf.Ledger(str(tmp_path))
    for m in _parity_metrics(5, n_runs=3):
        ref.record(m, env=REF_ENV, meta={"note": "reference"})
    port = Ledger(str(tmp_path))
    _same_runs(port.runs(), ref.runs())
    assert port.series() == ref.series() == ["grace-core/fp32"]
    (r,) = [r for r in port.runs() if r.seq == 2]
    assert r.env == dataclasses.replace(ENV, torch_version="unknown")
    assert port.next_seq() == 4
    # the port appends to the reference's trajectory, and both read it
    new = port.record(_parity_metrics(6, n_runs=1)[0], env=ENV)
    assert new.seq == 4
    _same_runs(ref_perf.Ledger(str(tmp_path)).runs(), port.runs())


def test_reference_ledger_reads_the_port_directory(tmp_path):
    port = Ledger(str(tmp_path))
    env = dataclasses.replace(ENV, chip="h100", cuda_version="12.8",
                              gpu="NVIDIA H100 80GB HBM3, 700.00 W")
    for m in _parity_metrics(7, n_runs=3):
        port.record(m, env=env)
    ref = ref_perf.Ledger(str(tmp_path))
    _same_runs(ref.runs(), port.runs())
    assert ref.series() == ["h100/fp32"]
    assert ref.latest().env.git_sha == "aaaa111"
    assert Ledger(str(tmp_path)).latest().env == env
    g = ref_perf.gate_run(ref.latest(), ref, tuning_store=None)
    pg = gate_run(port.latest(), port, tuning_store=None)
    assert g.to_dict() == pg.to_dict()


def test_default_directories_are_apart(tmp_path, monkeypatch):
    """Neither package's default ledger is the other's: the port's lives
    under ``torch/`` of ``$REPRO_ARTIFACT_DIR``, and an explicit directory
    reads either."""
    from repro_torch.analysis.store import default_store
    from repro_torch.perf import default_ledger, default_perf_dir

    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path))
    assert default_perf_dir() == str(tmp_path / "torch" / "perf")
    assert ref_perf.default_perf_dir() == str(tmp_path / "perf")
    assert default_store().cache_dir == str(tmp_path / "torch")
    ref_perf.default_ledger().record(_parity_metrics(8, 1)[0], env=REF_ENV)
    assert default_ledger().runs() == []
    assert len(Ledger(ref_perf.default_perf_dir()).runs()) == 1


def test_store_json_layer_matches_the_reference(tmp_path):
    """Put/get, corrupt-entry drops, stale versions and enumeration, with
    both packages' stores over one directory."""
    port, ref = ArtifactStore(str(tmp_path)), RefStore(str(tmp_path))
    port.put_json("a" * 32, {"workload": "w", "x": 1, "version": 9})
    ref.put_json("b" * 32, {"workload": "v", "x": 2})
    assert ref.get_json("a" * 32)["x"] == 1  # the store's stamp wins
    assert port.get_json("b" * 32)["x"] == 2
    assert port.entries() == ref.entries() == {"a" * 32: "w", "b" * 32: "v"}
    (tmp_path / ("c" * 32 + ".json")).write_text("{trunc")
    (tmp_path / ("d" * 32 + ".json")).write_text(json.dumps({"version": 0}))
    assert list(port.iter_json()) == list(ref.iter_json())
    assert port.get_json("c" * 32) is None and port.dropped_corrupt == 1
    assert port.get_json("d" * 32) is None and port.dropped_corrupt == 2
    assert port.get_json("e" * 32) is None
    assert (port.hits, port.misses, port.puts) == (1, 3, 1)
    assert not (tmp_path / ("c" * 32 + ".json")).exists()
    assert port.get_json("a" * 32)["workload"] == "w"
    port.discard("a" * 32)  # a typed layer's decode failure
    assert (port.hits, port.misses, port.dropped_corrupt) == (1, 4, 3)
    assert port.clear() == 1 and ref.entries() == {}


# ---------------------------------------------------------------------------
# Ledger keys: every fork, and combinations of forks
# ---------------------------------------------------------------------------


#: (report overrides) of the serve and scenario reports: each fork alone,
#: then combinations
_FORKS = [
    {}, {"prefill_chunk": 8}, {"kv_dtype": "int8"}, {"kv_dtype": "bf16"},
    {"share_prefixes": True}, {"spec_k": 2}, {"spec_k": 4,
                                              "spec_adaptive": True},
    {"spec_adaptive": True}, {"mesh": "2x2"}, {"scheduler": "wave"},
    {"spec_k": 2, "spec_adaptive": True, "mesh": "2x1"},
    {"prefill_chunk": 4, "kv_dtype": "int8", "share_prefixes": True,
     "spec_k": 3, "mesh": "1x2"},
    {"rejected": 2},
]


def _synth_stats(seed, **over):
    rng = np.random.default_rng(seed)
    stats = {name: (int(rng.integers(0, 200)) if name in _SERVING_INT_METRICS
                    else float(rng.uniform(0.0, 2.0)))
             for name in ref_perf.ledger._SERVING_METRICS}
    stats["mesh_devices"] = None if rng.random() < 0.5 else 4
    stats.update(wall_s=0.5, scheduler="continuous", kv_dtype="f32",
                 share_prefixes=False, mesh=None, **over)
    return stats


@pytest.mark.parametrize("fork", _FORKS, ids=[
    "+".join(f"{k}={v}" for k, v in f.items()) or "plain" for f in _FORKS])
def test_ledger_keys_equal_the_reference(fork):
    from repro.perf.ledger import metrics_from_scenario as ref_scenario
    from repro.perf.ledger import metrics_from_serving as ref_serving

    for seed in range(3):
        stats = _synth_stats(seed)
        if seed == 1:  # the forks as engine stats, the report silent
            stats.update(fork)
            rep = {"kind": "serve_report", "arch": "qwen3-1.7b",
                   "stats": stats}
        else:
            rep = {"kind": "serve_report", "arch": "qwen3-1.7b",
                   "scheduler": "continuous", "stats": stats, **fork}
        got = metrics_from_serving(rep)
        assert got == ref_serving(rep)
        (key, row), = got.items()
        assert key.startswith("serve/qwen3-1.7b@")
        assert all(isinstance(row[n], int) for n in row
                   if n in _SERVING_INT_METRICS)
        cell = {"kind": "scenario_cell", "cell_id": f"x/{seed}",
                "stats": stats, "restarts": seed,
                "rejected": [{"uid": 1, "reason": "r"}] * seed,
                "golden_checked": seed != 2, "golden_ok": seed == 0,
                "slo_failures": ["slow"] if seed == 2 else [],
                **({"ledger_key": f"scenario/y/{seed}"} if seed else {})}
        assert metrics_from_scenario(cell) == ref_scenario(cell)
    assert metrics_from_serving({"arch": "a", "stats": {}}) == {}
    assert metrics_from_scenario({"stats": {}}) == {}


def test_ledger_key_of_every_combination_of_forks():
    """Every combination of the six forks keys as the reference keys it,
    in the reference's order."""
    from repro.perf.ledger import metrics_from_serving as ref_serving

    keys = set()
    for chunk, kv, share, spec, adapt, mesh in itertools.product(
            (1, 8), ("f32", "bf16", "int8"), (False, True), (0, 2),
            (False, True), (None, "2x1")):
        rep = {"arch": "gpt2-124m", "scheduler": "continuous",
               "prefill_chunk": chunk, "kv_dtype": kv,
               "share_prefixes": share, "spec_k": spec,
               "spec_adaptive": adapt, "mesh": mesh,
               "stats": {"requests": 1, "fused_steps": 3}}
        (key,) = metrics_from_serving(rep)
        assert [key] == list(ref_serving(rep))
        keys.add(key)
    assert "serve/gpt2-124m@continuous+spec2+adapt+mesh2x1" in keys
    assert ("serve/gpt2-124m@continuous+prefill8+kvint8+shared+spec2+adapt"
            "+mesh2x1") in keys
    assert len(keys) == 2 * 3 * 2 * 3 * 2  # adapt forks only with spec


# ---------------------------------------------------------------------------
# One live run through both packages' --record
# ---------------------------------------------------------------------------


def test_default_serve_record_counters_equal_the_reference(tmp_path,
                                                           monkeypatch):
    """``python -m repro.launch.serve --record`` and ``python -m
    repro_torch.launch.serve --device cpu --record`` with the defaults:
    each package's ledger holds one ``serve/gpt2-124m@continuous`` row on
    ``grace-core/fp32``, with equal exact counters (the weights differ,
    the traffic and the schedule do not)."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve
    from repro_torch.perf import default_ledger

    monkeypatch.setenv("REPRO_ARTIFACT_DIR", str(tmp_path))
    assert ref_serve.main(["--record"]) == 0
    assert port_serve.main(["--device", "cpu", "--record"]) == 0
    (ref_run,) = ref_perf.default_ledger().runs()
    (port_run,) = default_ledger().runs()
    key = "serve/gpt2-124m@continuous"
    assert list(ref_run.metrics) == list(port_run.metrics) == [key]
    assert ref_run.env.series_key() == port_run.env.series_key() == \
        "grace-core/fp32"
    assert port_run.env.gpu == "" or torch.cuda.is_available()
    ref_row, row = ref_run.metrics[key], port_run.metrics[key]
    assert set(row) == set(ref_row)
    exact = [n for n in row if n in _SERVING_INT_METRICS] + [
        "slot_utilization", "ttft_p50_steps", "ttft_p95_steps"]
    assert {n: row[n] for n in exact} == {n: ref_row[n] for n in exact}
    assert row["new_tokens"] == 8 * 12 and row["requests"] == 8
