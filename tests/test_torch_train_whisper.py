"""The port's train stack on the encoder-decoder arch (whisper-large-v3)
against ``repro.train.steps``: batches (post-conv frames, tokens and
labels), forward logits, loss and gradients (through the encoder, the
cross-attention's flash backward with Sq != Sk and the decoder), three
train steps (params and optimizer state), the remat policies and the
parameter count, on the smoke config with the reference's weights (checks
and tolerances in ``tests/torch_train_checks.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402
import torch_train_checks as checks  # noqa: E402

torch_threads.use_threads(2)


@pytest.mark.parametrize("check", checks.CHECKS, ids=checks.check_id)
def test_train_stack_matches_the_reference(check):
    check("whisper-large-v3")
