"""The train step on meshes of ranks for every arch the dense and MoE
files leave out, against the reference's one-device step: mamba2 and
jamba (their mixers' heads and channels over ``model``, ``out_proj``
row-parallel), deepseek-v2-lite (MLA heads over ``model``, ``w_dkv``
whole), olmo, qwen2.5 (QKV bias), qwen3-32b, internvl2 (with
``img_embeds`` before the text) and whisper (encoder, decoder and cross
attention by the reference's rules), one step on 2x1 and 1x2.

One module-scoped spawn of 2x2 gloo ranks runs them all
(``tests/torch_train_mesh_checks.py``); tolerances as the one-device
train checks: rtol 1e-4 and atol 1e-5, 2e-4 for the mamba archs.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_threads  # noqa: E402
import torch_train_mesh_checks as mc  # noqa: E402

torch_threads.use_threads(2)

ARCHS = ("mamba2-370m", "jamba-1.5-large-398b", "deepseek-v2-lite-16b",
         "olmo-1b", "qwen2.5-14b", "qwen3-32b", "internvl2-76b",
         "whisper-large-v3")
SHAPES = ("2x1", "1x2")


@pytest.fixture(scope="module")
def runs():
    return mc.spawn_jobs([mc.steps_job(arch, arch, n_steps=1, seq=32,
                                       shapes=SHAPES, zeros=(True,))
                          for arch in ARCHS])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", SHAPES)
def test_mesh_step_equals_the_reference(runs, arch, shape):
    mc.assert_equals_the_reference(runs[arch][(shape, True)],
                                   mc.ref_run(arch, n_steps=1, seq=32), arch)
