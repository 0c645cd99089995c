"""The port's train stack on the MoE archs (deepseek-moe-16b; and
deepseek-v2-lite-16b, MLA, whose flash backward runs with ``Dv != D``)
against ``repro.train.steps``: batches, forward logits and the summed
load-balance aux, loss and gradients (the router's through the aux),
three train steps, the remat policies and the parameter count (checks
and tolerances in ``tests/torch_train_checks.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402
import torch_train_checks as checks  # noqa: E402

torch_threads.use_threads(2)

ARCHS = ["deepseek-moe-16b", "deepseek-v2-lite-16b"]


@pytest.mark.parametrize("check", checks.CHECKS, ids=checks.check_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_stack_matches_the_reference(arch, check):
    check(arch)
