"""mamba2 served by the port against the JAX package.

On the mamba2 smoke config (4 Mamba-2 layers, no attention and no FFN),
with the reference's weights carried across by ``params_from_numpy``
(checks in ``tests/torch_stateful_checks.py``):

* ``decode_step_paged`` and ``prefill_step_paged``: logits of live rows at
  rtol 1e-4, atol 1e-5, the recurrent states at rtol 2e-4, atol 2e-4 (the
  port's chunk step runs the SSD dual form where the reference scans the
  recurrence); a slot fed nothing keeps its state bit for bit;
* the cache: ``ssm_state`` and ``conv_state`` stacked over the mamba
  layers, never quantized, no K/V pool, and ``paged_block_bytes`` 0 as
  the reference's, for the full and smoke configs and every ``kv_dtype``;
  ``copy_paged_block`` leaves the states and ``reset_paged_slots`` zeroes
  the slots it names;
* greedy streams, fused steps and block histories equal to
  ``repro.serve.engine``'s, token by token and chunked, on f32, bf16 and
  int8 pools, with prefix sharing on and off, and after a preemption;
* the CLI with the reference's weights against the reference CLI;
* meshes: the serve rules keep the state whole on 1x1 and split it on
  1x2 and 2x1; ``mesh_check`` serves ``mamba2`` by default (the streams on
  every mesh shape are held in ``tests/test_torch_stateful_mesh.py``).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.register_assert_rewrite("torch_stateful_checks")

import torch_stateful_checks as checks  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import mesh_check  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
ARCH = "mamba2-370m"


def _m():
    return checks.model(ARCH)


def test_layers_are_mixers_only():
    m = _m()
    checks.check_layers_follow_the_superblock(m)
    assert all(set(p) == {"norm1", "mamba"} for p in m.params["layers"])
    assert not transformer.has_state(
        checks.port_configs.get_smoke_config("gpt2-124m"))
    assert transformer.has_state(m.cfg)


def test_decode_step_paged_matches_reference():
    checks.check_decode_step(_m())


def test_decode_step_paged_under_int8_kv_dtype_matches_reference():
    """mamba2 has no K/V pool: its states are never quantized, so an int8
    ``kv_dtype`` serves the f32 numbers."""
    checks.check_decode_step(_m(), kv_dtype="int8")


def test_prefill_step_paged_matches_reference():
    checks.check_prefill_step(_m())


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_paged_cache_and_block_bytes_match_the_reference(size, kv_dtype):
    checks.check_pools_and_block_bytes(ARCH, size, kv_dtype)
    cfg = checks.port_configs.get_config(ARCH)
    assert transformer.paged_block_bytes(cfg, 16, kv_dtype) == 0


def test_copy_leaves_the_states_and_reset_zeroes_named_slots():
    checks.check_copy_and_reset(_m())


@pytest.mark.parametrize("chunk", [1, 4], ids=["token", "chunked"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("share", [False, True], ids=["own", "shared"])
def test_greedy_streams_equal_the_reference_engine(chunk, kv_dtype, share):
    checks.check_streams_equal_the_reference(_m(), chunk, kv_dtype, share)


def test_dedup_ratio_without_kv_bytes_falls_back_to_blocks(tmp_path):
    """mamba2 pages no K/V bytes, so the dedup ratio is the reference's
    block-count fallback, logical over physical blocks: the JAX engine's
    on prompts that share a prefix (held in
    ``check_streams_equal_the_reference``), and above 1 on the CLI's
    ``--share-prefixes`` traffic, where it used to read 1.0."""
    port = checks.check_streams_equal_the_reference(_m(), 1, "f32", True)
    st = port.stats()
    assert st["kv_bytes_served"] == 0
    assert st["block_dedup_ratio"] == \
        st["logical_blocks"] / st["physical_blocks"] > 1
    out = tmp_path / "report.json"
    assert serve_cli.main(["--device", "cpu", "--arch", ARCH, "--requests",
                           "4", "--share-prefixes", "--shared-prefix-len",
                           "16", "--out", str(out)]) == 0
    stats = json.loads(out.read_text())["stats"]
    assert (stats["logical_blocks"], stats["physical_blocks"]) == (11, 8)
    assert stats["block_dedup_ratio"] == 11 / 8


@pytest.mark.parametrize("chunk", [1, 4], ids=["token", "chunked"])
def test_preempted_stream_equals_the_reference_engine(chunk):
    checks.check_preempt(_m(), chunk)


def test_cli_serves_the_reference_cli_streams(tmp_path, monkeypatch):
    checks.check_cli(_m(), tmp_path, monkeypatch,
                     ["--prefill-chunk", "4", "--prefill-budget", "8"])


# -- meshes -------------------------------------------------------------------


def test_ssm_state_never_model_sharded_on_1x1():
    """Mirror of the reference's: on a 1x1 mesh the recurrent states do
    not pick up ``model``, and the serve rules equal the plain rules
    (the mamba replication fires only on 2-D meshes); on 1x2 the states
    split heads and channels, on 2x1 slots, on 2x2 nothing."""
    for key, shape in (("ssm_state", (4, 2, 8, 16, 16)),
                       ("conv_state", (4, 2, 3, 32))):
        assert "model" not in sharding.paged_cache_spec(key, shape,
                                                        MeshShape(1, 1))
        assert sharding.paged_cache_spec(key, shape, MeshShape(2, 2)) == \
            (None,) * len(shape)
        assert sharding.paged_cache_spec(key, shape, MeshShape(2, 1))[1] \
            == "data"
    assert sharding.paged_cache_spec("ssm_state", (4, 2, 8, 16, 16),
                                     MeshShape(1, 2))[2] == "model"
    params = _m().params
    for shape in ((1, 1), (2, 1)):
        mesh = MeshShape(*shape)
        assert sharding.serve_param_shardings(params, mesh) == \
            sharding.map_paths(params, lambda path, leaf:
                               sharding.spec_for_path(
                                   path, tuple(leaf.shape), mesh))
    flat = []
    sharding.map_paths(params, lambda path, leaf: flat.append((
        path, sharding.serve_spec(path, tuple(leaf.shape), MeshShape(2, 2)))))
    assert all("model" not in spec for path, spec in flat
               if "/mamba/" in path)


def test_mesh_check_serves_mamba2_by_default():
    assert "mamba2" in mesh_check.SERVED
    assert dict((w[0], w[1]) for w in mesh_check.DEFAULT_WORKLOADS)[
        "mamba2"] == ARCH
    np.testing.assert_equal(
        [w[0] for w in mesh_check.DEFAULT_WORKLOADS if w[0] in
         mesh_check.SERVED],
        list(mesh_check.SERVED))
