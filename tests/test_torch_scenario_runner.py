"""The port's scenario runner against ``repro.scenarios.runner`` on the
same cells and the same parameters.

The port's per-arch parameter cache is filled with the JAX runner's own
smoke parameters (``init_model(PRNGKey(0))``, carried across with
``params_from_numpy``).  Then gpt2-124m and qwen3-1.7b smoke cells of every
fault plan, under both schedulers and with ``prefill_chunk`` 4, must serve
the JAX runner's streams, rejections (uids and reasons) and exact stats,
and each faulted or chunked cell must equal its twins.  The contract tests
of ``tests/test_scenarios.py`` that run cells follow, and those that read
the perf ledger.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.perf import Ledger, gate_run  # noqa: E402
from repro_torch.perf.ledger import metrics_from_scenario  # noqa: E402
from repro_torch.scenarios import SLOSpec  # noqa: E402
from repro_torch.scenarios import runner  # noqa: E402
import torch_threads  # noqa: E402
from torch_scenario_checks import (  # noqa: E402
    assert_like_jax,
    carry_jax_params,
    one_cell as _cell,
    run,
    tiny_matrix as _tiny_matrix,
)

torch_threads.use_threads(2)
carry_jax_params()

ARCHS = ("gpt2-124m", "qwen3-1.7b")


#: every fault plan under both schedulers (wave skips preempt), and
#: chunked by 4 under a budget of 8, for both archs
CELLS = [c for arch in ARCHS for c in _tiny_matrix(
    archs=[arch], schedulers=["continuous", "wave"],
    faults=["none", "preempt", "device-loss", "malformed"],
    prefill_chunks=[1, 4], prefill_budget=8).cells()]


@pytest.mark.parametrize("cell", CELLS, ids=[c.cell_id for c in CELLS])
def test_cell_equals_the_jax_runner(cell):
    mine = assert_like_jax(cell)
    assert mine.golden_checked == (cell.fault != "none"
                                   or cell.prefill_chunk > 1)


# ---------------------------------------------------------------------------
# fault plans: golden-twin token equivalence (tests/test_scenarios.py)
# ---------------------------------------------------------------------------


def test_preempt_cell_matches_golden_twin():
    r = run(_cell("preempt"))
    assert r.error == ""
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["preemptions"] >= 1, "the fault must actually fire"
    assert r.slo_failures == []
    assert r.ok


def test_malformed_cell_rejects_and_matches_twin():
    r = run(_cell("malformed"))
    assert r.error == ""
    assert len(r.rejected) == 2, "oversized + empty must both be rejected"
    assert {u for u, _ in r.rejected} == {100_000, 100_001}
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["rejected"] == 2


def test_device_loss_cell_restarts_and_matches_twin():
    r = run(_cell("device-loss"))
    assert r.error == ""
    assert r.restarts >= 1, "the simulated device loss must actually fire"
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["restarts"] == r.restarts


def test_slo_violation_fails_cell():
    r = run(_cell("none", slo=SLOSpec(min_tok_s=1e12)))
    assert r.error == "" and r.slo_failures and not r.ok


def test_run_matrix_only_filter_and_markdown(tmp_path):
    spec = _tiny_matrix(faults=["none", "malformed"])
    results = runner.run_matrix(spec, only="*malformed", record=True,
                                ledger=Ledger(str(tmp_path)), device="cpu")
    assert [r.cell.fault for r in results] == ["malformed"]
    md = runner.format_matrix_markdown(results)
    assert "| cell |" in md and results[0].cell.cell_id in md
    assert results[0].tokens == run(_cell("malformed")).tokens
    assert Ledger(str(tmp_path)).latest() is not None


# ---------------------------------------------------------------------------
# ledger recording + perf gate (tests/test_scenarios.py)
# ---------------------------------------------------------------------------


def test_metrics_from_scenario_schema():
    """The preempt cell's row: the reference's keys, and on the JAX
    runner's result of the same cell the reference's row, its exact
    counters equal."""
    import repro.scenarios.runner as ref_runner
    from repro.perf.ledger import metrics_from_scenario as ref_metrics
    from torch_scenario_checks import ref_cell

    cell = _cell("preempt")
    metrics = metrics_from_scenario(run(cell).report())
    (key, row), = metrics.items()
    assert key == cell.ledger_key
    assert key.startswith("scenario/")
    for name in ("tok_s", "slot_utilization", "ttft_p50_s", "ttft_p95_s",
                 "preemptions", "rejected", "restarts"):
        assert name in row, f"missing {name}"
    assert row["golden_ok"] is True and row["slo_ok"] is True
    (rkey, rrow), = ref_metrics(
        ref_runner.run_cell(ref_cell(cell)).report()).items()
    assert rkey == key and set(rrow) == set(row)
    assert {n: row[n] for n in row if not n.endswith("_s")} == {
        n: rrow[n] for n in rrow if not n.endswith("_s")}


def test_recorded_cell_gates_against_its_own_trajectory(tmp_path):
    ledger = Ledger(str(tmp_path))
    r = run(_cell("preempt"))
    first = runner.record_cell(r, ledger=ledger)
    assert first.meta["sources"] == ["scenario"]
    # identical stats re-recorded: the per-cell gate must PASS (the
    # latest-comparable fallback pairs runs on the shared scenario/ key)
    second = runner.record_cell(r, ledger=ledger)
    gate = gate_run(second, ledger, tuning_store=None)
    assert gate.ok, [x.describe() for x in gate.comparison.regressions]
    assert r.cell.ledger_key in second.metrics


def test_golden_flip_and_new_faults_regress(tmp_path):
    ledger = Ledger(str(tmp_path))
    r = run(_cell("preempt"))
    good = metrics_from_scenario(r.report())
    ledger.record(good)
    key = r.cell.ledger_key
    bad = {key: dict(good[key], golden_ok=False,
                     rejected=good[key]["rejected"] + 1)}
    worse = ledger.record(bad)
    gate = gate_run(worse, ledger, tuning_store=None)
    assert not gate.ok
    names = {x.metric for x in gate.comparison.regressions}
    assert {"golden_ok", "rejected"} <= names


def test_run_matrix_threads_serve_the_sequential_streams():
    """``jobs > 1``: one engine a cell, the parameter cache shared behind
    its lock; the streams are the sequential run's."""
    spec = _tiny_matrix(faults=["none", "preempt", "malformed"])
    results = runner.run_matrix(spec, jobs=3, device="cpu")
    assert [r.cell for r in results] == spec.cells()
    for r in results:
        assert r.ok and r.tokens == run(r.cell).tokens


def test_record_is_refused_naming_the_ledger_item(tmp_path):
    """Recording is ported (ROADMAP 1.15): ``record_cell`` appends the
    cell's ``scenario/<cell_id>`` row, and ``run_matrix(record=True)``
    one run per cell that did not error, stamped with the chip of its
    device."""
    from repro_torch.perf import Ledger

    ledger = Ledger(str(tmp_path))
    r = run(_cell("preempt"))
    first = runner.record_cell(r, ledger=ledger)
    assert first.meta == {"sources": ["scenario"],
                          "scenario": r.cell.cell_id, "fault": "preempt"}
    assert list(first.metrics) == [r.cell.ledger_key]
    results = runner.run_matrix(_tiny_matrix(faults=["none", "malformed"]),
                                record=True, ledger=ledger, device="cpu")
    runs = ledger.runs()
    assert [x.seq for x in runs] == [1, 2, 3]
    assert [list(x.metrics) for x in runs[1:]] == [
        [c.cell.ledger_key] for c in results]
    assert {x.env.series_key() for x in runs} == {"grace-core/fp32"}


def test_ttft_tracked_per_request():
    s = run(_cell("preempt")).stats
    assert s["ttft_p50_s"] > 0.0
    assert s["ttft_p95_s"] >= s["ttft_p50_s"]
    assert s["ttft_p50_s"] <= s["p50_latency_s"] + 1e-9


def test_chunked_preempt_cell_matches_both_twins():
    """Chunked prefill + mid-flight preemption must match the fault-free
    twin AND the token-by-token chunk twin, uid-for-uid."""
    spec = _tiny_matrix(faults=["preempt"], prefill_chunks=[8],
                        prefill_budget=8)
    cell, = spec.cells()
    r = run(cell)
    assert r.error == ""
    assert r.stats["preemptions"] >= 1
    assert r.golden_checked and r.golden_ok, r.golden_diffs
    assert r.stats["prefill_chunk"] == 8
    rep = r.report()
    assert rep["prefill_chunk"] == 8 and rep["prefill_budget"] == 8
    assert r.stats["ttft_p95_steps"] >= 1.0
    (key, row), = metrics_from_scenario(rep).items()
    assert key.endswith("/pc8")
    assert row["prefill_chunk"] == 8
    assert row["ttft_p95_steps"] >= 1.0


def test_slo_ttft_steps_ceiling():
    cell = _cell("none", prefill_chunks=[8], prefill_budget=8,
                 slo=SLOSpec(max_ttft_p95_steps=0.0))
    r = run(cell)
    assert r.error == "" and r.slo_failures and not r.ok
    assert any("TTFT steps" in m for m in r.slo_failures)


def test_cells_run_on_the_card_unless_asked():
    """``device`` defaults to the card: where there is none, the cell
    fails with the device's error and nothing falls back to the CPU."""
    r = runner.run_cell(_cell("none"))
    if torch.cuda.is_available():
        assert r.ok and r.stats["requests"] == 4
    else:
        assert not r.ok and "torch.cuda.is_available() is False" in r.error


# -- the near-tie rule of bf16 twins ---------------------------------------------


def _synthetic_forward(top, second):
    """A teacher-forced forward whose next-token logits are ``top`` at
    token 3, ``second`` at token 5 and 0 elsewhere."""
    def forward(params, cfg, tokens):
        logits = torch.zeros((1, tokens.shape[1], 16))
        logits[0, -1, 3], logits[0, -1, 5] = top, second
        return logits, torch.zeros(())
    return forward


@pytest.mark.parametrize("ulps, tie", [(0, True), (4, True), (5, False)])
def test_a_twin_diff_is_a_near_tie_within_the_rule(monkeypatch, ulps, tie):
    """A diverged stream whose top-2 gap where it leaves its twin is at
    most ``TIE_ULPS`` bf16 ulps of the top logit is a tie, reported with
    its gap; one ulp over the rule it stays a diff.  The top logit 8.0
    has a bf16 ulp of 1/16."""
    cfg = type("Cfg", (), {"vocab": 16})()
    gap = ulps / 16
    monkeypatch.setattr(runner.transformer, "forward",
                        _synthetic_forward(8.0, 8.0 - gap))
    diffs = ["[vs prefill_chunk=1] uid 2: tokens diverged "
             "([7, 3, 1] != [7, 5, 1])",
             "uid 4: served in golden twin, missing here"]
    ties, rest = runner.judge_ties(cfg, None, {2: [9, 9]}, diffs, "cpu")
    assert rest[-1] == diffs[1]  # a missing request is never a tie
    if tie:
        assert ties == [{"twin": "prefill_chunk=1", "uid": 2, "index": 1,
                         "top2_gap": gap, "top_ulp": 1 / 16}]
        assert rest == diffs[1:]
    else:
        assert ties == [] and len(rest) == 2
        assert rest[0].startswith(diffs[0]) and "top-2 gap" in rest[0]
    assert runner.TIE_ULPS == 4


def test_an_f32_cell_judges_no_ties():
    """The tie rule reads only cells that compute in bf16: the smoke
    cells (f32) keep exact twins."""
    cell = _cell("preempt", archs=["qwen3-1.7b"], prefill_chunks=[4],
                 prefill_budget=8)
    r = run(cell)
    assert r.ties == [] and r.golden_ok
    assert "ties" not in r.report()  # as the reference's report
