"""Scenario cells of the serve archs beyond gpt2-124m and qwen3-1.7b:
deepseek-moe-16b, mamba2-370m, jamba-1.5-large-398b and
deepseek-v2-lite-16b, each as one continuous smoke cell under the
``preempt`` plan, through the port's runner and ``repro.scenarios.runner``
on the JAX runner's own parameters.

The streams, rejections, restarts and exact stats must be the JAX
runner's, the cell must equal its fault-free twin, and the exact counters
of its perf-ledger row (``metrics_from_scenario``) must equal the
reference's row on the JAX runner's result.
"""

import pytest

torch = pytest.importorskip("torch")

import repro.scenarios.runner as ref_runner  # noqa: E402
from repro.perf.ledger import metrics_from_scenario as ref_metrics  # noqa: E402
from repro_torch.perf.ledger import metrics_from_scenario  # noqa: E402
import torch_threads  # noqa: E402
from torch_scenario_checks import (  # noqa: E402
    EXACT,
    carry_jax_params,
    one_cell,
    ref_cell,
    run,
)

torch_threads.use_threads(2)

ARCHS = ("deepseek-moe-16b", "mamba2-370m", "jamba-1.5-large-398b",
         "deepseek-v2-lite-16b")
carry_jax_params(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_preempt_cell_equals_the_jax_runner(arch):
    cell = one_cell("preempt", archs=[arch])
    mine = run(cell)
    theirs = ref_runner.run_cell(ref_cell(cell))
    assert mine.error == theirs.error == ""
    assert mine.tokens == theirs.tokens
    assert mine.rejected == theirs.rejected
    assert mine.restarts == theirs.restarts
    assert {k: mine.stats[k] for k in EXACT} == {
        k: theirs.stats[k] for k in EXACT}
    assert mine.stats["preemptions"] >= 1, "the fault must actually fire"
    assert mine.golden_checked and mine.ok, mine.golden_diffs
    (key, row), = metrics_from_scenario(mine.report()).items()
    (rkey, rrow), = ref_metrics(theirs.report()).items()
    assert key == rkey == cell.ledger_key
    assert set(row) == set(rrow)
    exact = [n for n in row if not n.endswith("_s")]
    assert {n: row[n] for n in exact} == {n: rrow[n] for n in exact}
