"""The port's dense path against the JAX package's, for the dense and
MoE grouped-query archs: ``init_cache`` shapes and dtypes, ``forward``
logits, ``prefill`` logits and cache, and a ``decode_step`` loop held to
the JAX loop and to the port's own ``forward`` (the reference's
serving-consistency contract, ``tests/test_serving_consistency.py``),
with the contiguous flash-decode wrapper (kernel 2.3 on the card) called
once a grouped-query layer a step.  Tolerances in
``tests/torch_dense_checks.py``.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_dense_checks as checks  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

ARCHS = ("gpt2-124m", "qwen3-1.7b", "deepseek-moe-16b")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_the_reference(arch):
    checks.check_init_cache(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch):
    checks.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_the_reference(arch):
    checks.check_prefill(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_loop_matches_the_reference_and_forward(arch, monkeypatch):
    checks.check_decode_loop(arch, monkeypatch)


@pytest.mark.parametrize("arch", ("gpt2-124m", "qwen3-1.7b"))
def test_dense_decode_layer_matches_the_reference(arch):
    checks.check_decode_module(arch)
