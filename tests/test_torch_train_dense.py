"""The port's train stack on the dense decoder archs and the VLM stub
(gpt2-124m, qwen3-1.7b, olmo-1b, qwen2.5-14b, qwen3-32b, internvl2-76b)
against ``repro.train.steps``: batches, forward logits, loss and
gradients, three train steps (params and optimizer state), the remat
policies and the parameter count, each on the arch's smoke config with
the reference's weights (checks and tolerances in
``tests/torch_train_checks.py``), and internvl2's prefill with image
embeddings.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402
import torch_train_checks as checks  # noqa: E402

torch_threads.use_threads(2)

ARCHS = ["gpt2-124m", "qwen3-1.7b", "olmo-1b", "qwen2.5-14b", "qwen3-32b",
         "internvl2-76b"]


@pytest.mark.parametrize("check", checks.CHECKS, ids=checks.check_id)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_stack_matches_the_reference(arch, check):
    check(arch)


def test_vlm_prefill_with_image_embeddings():
    checks.check_prefill_with_image("internvl2-76b")
