"""The port's dense path against the JAX package's, for the archs with
recurrent state or latent caches (mamba2-370m, jamba-1.5-large-398b,
deepseek-v2-lite-16b): the checks of ``tests/test_torch_dense_serve.py``.
A prefill hands a mamba layer's final state and conv tail to the cache,
and a decode loop carries them on; an MLA layer's latent rows are
committed and attended in the absorbed form, with no kernel launch (the
MLA layer alone, ``mla_decode_dense``, is held in
``tests/test_torch_wave_stateful.py``, which balances the files' time).
"""

import pytest

torch = pytest.importorskip("torch")

import torch_dense_checks as checks  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

ARCHS = ("mamba2-370m", "jamba-1.5-large-398b", "deepseek-v2-lite-16b")


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
