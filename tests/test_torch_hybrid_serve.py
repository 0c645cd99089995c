"""jamba served by the port against the JAX package.

On the jamba smoke config (one superblock of 7 Mamba-2 layers and an
attention layer at slot 4, MoE FFNs of 4 experts, top 2, on the odd
layers, dense FFNs on the even ones), and on the same config with 16
routed experts, the routing of the full config, with the reference's
weights carried across by ``params_from_numpy`` (checks in
``tests/torch_stateful_checks.py``):

* ``decode_step_paged`` and ``prefill_step_paged``: logits of live rows
  and the K/V pool of the attention layer at rtol 1e-4, atol 1e-5, the
  recurrent states at rtol 2e-4, atol 2e-4;
* the cache: K/V pools stacked over the one attention layer, states over
  the seven mamba layers, and ``paged_block_bytes`` equal to the
  reference's (one attention layer's) for the full and smoke configs and
  every ``kv_dtype``; ``copy_paged_block`` leaves the states and
  ``reset_paged_slots`` zeroes the slots it names;
* greedy streams, fused steps and block histories equal to
  ``repro.serve.engine``'s, token by token and chunked, on f32, bf16 and
  int8 pools, with prefix sharing on and off, and after a preemption;
* the CLI with the reference's weights against the reference CLI;
* ``mesh_check`` serves ``jamba`` by default (the streams on every mesh
  shape are held in ``tests/test_torch_stateful_mesh.py``).
"""

import pytest

torch = pytest.importorskip("torch")
pytest.register_assert_rewrite("torch_stateful_checks")

import torch_stateful_checks as checks  # noqa: E402
from repro_torch.configs.base import LayerKind  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import mesh_check  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
ARCH = "jamba-1.5-large-398b"
EXPERTS = [None, 16]
EXPERT_IDS = ["smoke-experts", "16-experts"]


def _m(n_routed=None):
    return checks.model(ARCH, n_routed)


def test_layers_follow_the_superblock():
    m = _m()
    checks.check_layers_follow_the_superblock(m)
    kinds = [transformer.layer_kind(m.cfg, i) for i in range(8)]
    assert kinds == [LayerKind.MAMBA] * 4 + [LayerKind.ATTN] + \
        [LayerKind.MAMBA] * 3
    assert [("moe" in p) for p in m.params["layers"]] == [False, True] * 4
    assert all("ffn" in p for p in m.params["layers"][::2])
    assert [pool for _, pool in transformer.layer_pools(m.cfg)] == \
        [0, 1, 2, 3, 0, 4, 5, 6]


@pytest.mark.parametrize("n_routed", EXPERTS, ids=EXPERT_IDS)
def test_decode_step_paged_matches_reference(n_routed):
    checks.check_decode_step(_m(n_routed))


@pytest.mark.parametrize("n_routed", EXPERTS, ids=EXPERT_IDS)
def test_prefill_step_paged_matches_reference(n_routed):
    checks.check_prefill_step(_m(n_routed))


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_paged_cache_and_block_bytes_match_the_reference(size, kv_dtype):
    checks.check_pools_and_block_bytes(ARCH, size, kv_dtype)


def test_copy_leaves_the_states_and_reset_zeroes_named_slots():
    checks.check_copy_and_reset(_m())


@pytest.mark.parametrize("chunk", [1, 4], ids=["token", "chunked"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("share", [False, True], ids=["own", "shared"])
def test_greedy_streams_equal_the_reference_engine(chunk, kv_dtype, share):
    checks.check_streams_equal_the_reference(_m(), chunk, kv_dtype, share)


@pytest.mark.parametrize("chunk", [1, 4], ids=["token", "chunked"])
def test_greedy_streams_with_16_experts_equal_the_reference_engine(chunk):
    checks.check_streams_equal_the_reference(_m(16), chunk, "f32", False)


@pytest.mark.parametrize("chunk", [1, 4], ids=["token", "chunked"])
def test_preempted_stream_equals_the_reference_engine(chunk):
    checks.check_preempt(_m(), chunk)


def test_cli_serves_the_reference_cli_streams(tmp_path, monkeypatch):
    checks.check_cli(_m(), tmp_path, monkeypatch,
                     ["--prefill-chunk", "4", "--prefill-budget", "8"])


def test_mesh_check_serves_jamba_by_default():
    assert "jamba" in mesh_check.SERVED
    assert dict((w[0], w[1]) for w in mesh_check.DEFAULT_WORKLOADS)[
        "jamba"] == ARCH
