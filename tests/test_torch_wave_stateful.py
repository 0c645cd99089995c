"""The port's wave engine against the JAX wave engine for the archs with
recurrent state or latent caches: mamba2-370m, jamba-1.5-large-398b and
deepseek-v2-lite-16b, the checks of ``tests/test_torch_wave.py``.  Each
wave starts from zeroed states in a fresh dense cache; MoE layers route
the step's slots as one group, idle and finished slots included, so
with the configs' own capacity the drops are the reference's too.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_dense_checks as checks  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)


@pytest.mark.parametrize("arch,tight", [
    ("mamba2-370m", False), ("jamba-1.5-large-398b", False),
    ("jamba-1.5-large-398b", True), ("deepseek-v2-lite-16b", False),
    ("deepseek-v2-lite-16b", True)])
def test_wave_matches_the_jax_wave_engine(arch, tight):
    checks.check_wave(arch, tight_moe=tight)


def test_dense_mla_decode_layer_matches_the_reference():
    """``mla_decode_dense`` against the reference's ``mla_decode``, with
    per-slot and shared positions (``tests/torch_dense_checks.py``)."""
    checks.check_decode_module("deepseek-v2-lite-16b")
