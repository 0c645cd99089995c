"""The port's scenario runner against ``repro.scenarios.runner`` on the
same cells and the same parameters.

The port's per-arch parameter cache is filled with the JAX runner's own
smoke parameters (``init_model(PRNGKey(0))``, carried across with
``params_from_numpy``).  Then gpt2-124m and qwen3-1.7b smoke cells of every
fault plan, under both schedulers and with ``prefill_chunk`` 4, must serve
the JAX runner's streams, rejections (uids and reasons) and exact stats,
and each faulted or chunked cell must equal its twins.  The contract tests
of ``tests/test_scenarios.py`` that run cells follow, except those that
read the perf ledger (ROADMAP item 1.15).
"""

import pytest

torch = pytest.importorskip("torch")

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


def test_run_matrix_only_filter_and_markdown():
    spec = _tiny_matrix(faults=["none", "malformed"])
    results = runner.run_matrix(spec, only="*malformed", device="cpu")
    assert [r.cell.fault for r in results] == ["malformed"]
    md = runner.format_matrix_markdown(results)
    assert "| cell |" in md and results[0].cell.cell_id in md
    assert results[0].tokens == run(_cell("malformed")).tokens


def test_run_matrix_threads_serve_the_sequential_streams():
    """``jobs > 1``: one engine a cell, the parameter cache shared behind
    its lock; the streams are the sequential run's."""
    spec = _tiny_matrix(faults=["none", "preempt", "malformed"])
    results = runner.run_matrix(spec, jobs=3, device="cpu")
    assert [r.cell for r in results] == spec.cells()
    for r in results:
        assert r.ok and r.tokens == run(r.cell).tokens


def test_record_is_refused_naming_the_ledger_item():
    with pytest.raises(NotImplementedError,
                       match="the perf ledger: ROADMAP item 1.15"):
        runner.record_cell(run(_cell("preempt")))
    with pytest.raises(NotImplementedError, match="ROADMAP item 1.15"):
        runner.run_matrix(_tiny_matrix(), record=True, device="cpu")


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
