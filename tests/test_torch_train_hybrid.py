"""The port's train stack on the hybrid arch (jamba-1.5-large-398b: a
superblock of Mamba-2 mixers and an attention layer, with dense and MoE
FFNs) against ``repro.train.steps``: batches, forward logits, loss and
gradients, three train steps held at the SSD bound (rtol and atol 2e-4),
the remat policies and the parameter count (checks and tolerances in
``tests/torch_train_checks.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402
import torch_train_checks as checks  # noqa: E402

torch_threads.use_threads(2)

ARCHS = ["jamba-1.5-large-398b"]


@pytest.mark.parametrize("check", checks.CHECKS, ids=checks.check_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_stack_matches_the_reference(arch, check):
    check(arch)
