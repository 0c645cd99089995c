"""deepseek-v2-lite served by the port against the JAX package.

On the deepseek-v2-lite smoke config (3 layers: a dense first layer, then
two MoE layers of 8 experts, top 2, one shared expert; every layer MLA
over latent pools of 32 + 8 elements a row), with the reference's weights
carried across by ``params_from_numpy`` (checks in
``tests/torch_stateful_checks.py``):

* ``decode_step_paged`` and ``prefill_step_paged``: logits of live rows and
  the latent pools at rtol 1e-4, atol 1e-5 against the reference's steps
  (the port commits then attends, and computes a chunk in parallel where
  the reference scans its one-token cell);
* teacher-forced logits under bf16 and int8 latent pools within the
  reference's own budgets against the f32 cache (0.035 and 0.13), and the
  chunk step's equal to the token-by-token step's;
* greedy streams, fused steps and block histories equal to
  ``repro.serve.engine``'s, token by token and chunked, on f32, bf16 and
  int8 pools, with prefix sharing on and off, and after a preemption;
* sharing on against off: equal streams, fewer physical blocks, a dedup
  ratio above 1, and identical prompts copying on write;
* the CLI against the reference CLI, and on a one-rank mesh in this
  process against the unsharded engine and the JAX engine (the multi-rank
  shapes are in ``tests/test_torch_mla.py``); ``mesh_check`` serves
  ``mla`` by default.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.register_assert_rewrite("torch_stateful_checks")

from repro.models import transformer as ref_tf  # noqa: E402
import torch_stateful_checks as checks  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import mesh_check  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
ARCH = "deepseek-v2-lite-16b"
#: the reference's teacher-forced budgets against the f32 cache
#: (``tests/test_serve_sharing.py``'s ``_KV_TOL``)
KV_TOL = {"bf16": 0.035, "int8": 0.13}


def _m():
    return checks.model(ARCH)


def test_layers_are_first_block_then_the_stacked_blocks():
    m = _m()
    params, tree = m.params, m.tree
    assert len(params["layers"]) == m.cfg.n_layers == 3
    assert all("mla" in p and "attn" not in p for p in params["layers"])
    assert "ffn" in params["layers"][0]
    assert all("moe" in p for p in params["layers"][1:])
    np.testing.assert_array_equal(
        params["layers"][0]["mla"]["w_uk"]["w"].numpy(),
        tree["first_block"]["mla"]["w_uk"]["w"])
    for i in (1, 2):
        np.testing.assert_array_equal(
            params["layers"][i]["mla"]["w_dkv"]["w"].numpy(),
            tree["blocks"]["slot0"]["mla"]["w_dkv"]["w"][i - 1])
    own = transformer.init_lm(m.cfg, seed=0, device="cpu")
    assert checks._paths(own) == checks._paths(params)


def test_decode_step_paged_matches_reference():
    checks.check_decode_step(_m())


def test_prefill_step_paged_matches_reference():
    checks.check_prefill_step(_m())


def _forced_logits(kv_dtype, chunked=False, reference=False, T=14):
    """2 slots, 14 forced tokens, max_len 32, blocks of 8 (the reference
    test's configuration); token by token or as one chunk."""
    m = _m()
    B = 2
    toks = np.random.default_rng(13).integers(0, m.cfg.vocab, (B, T)).astype(
        np.int32)
    bt = np.arange(1, 1 + B * 4, dtype=np.int32).reshape(B, 4)
    if reference:
        cache = ref_tf.init_paged_cache(m.rcfg, B, 32, 8, kv_dtype=kv_dtype)
        step = jax.jit(lambda p, t, c, pos: ref_tf.decode_step_paged(
            p, m.rcfg, t, c, pos, jnp.asarray(bt), block_size=8,
            kv_dtype=kv_dtype))
        out = []
        for t in range(T):
            logits, cache = step(m.rp, jnp.asarray(toks[:, t:t + 1]), cache,
                                 jnp.full((B,), t, jnp.int32))
            out.append(np.asarray(logits))
        return np.stack(out)
    cache = transformer.init_paged_cache(m.cfg, B, 32, 8, "cpu",
                                         kv_dtype=kv_dtype)
    if chunked:
        logits, _ = transformer.prefill_step_paged(
            m.params, m.cfg, torch.from_numpy(toks), cache,
            torch.zeros(B, dtype=torch.int32), torch.from_numpy(bt),
            torch.full((B,), T, dtype=torch.int32), block_size=8,
            kv_dtype=kv_dtype)
        return logits.transpose(0, 1)[:, :, None].numpy()
    out = []
    for t in range(T):
        logits, cache = transformer.decode_step_paged(
            m.params, m.cfg, torch.from_numpy(toks[:, t:t + 1]), cache,
            torch.full((B,), t, dtype=torch.int32), torch.from_numpy(bt),
            block_size=8, kv_dtype=kv_dtype)
        out.append(logits.numpy())
    return np.stack(out)


def test_teacher_forced_logits_within_the_reference_budgets():
    port = {kd: _forced_logits(kd) for kd in ("f32", "bf16", "int8")}
    jax_f32 = _forced_logits("f32", reference=True)
    np.testing.assert_allclose(port["f32"], jax_f32, rtol=1e-4, atol=1e-5)
    for kd, tol in KV_TOL.items():
        assert np.abs(port[kd] - port["f32"]).max() <= tol, kd
        assert np.abs(port[kd] - jax_f32).max() <= tol, kd
        assert np.abs(port[kd] - _forced_logits(kd, reference=True)).max() \
            <= tol, kd


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_chunked_teacher_forced_matches_token_by_token(kv_dtype):
    """The chunk step commits rows with the decode step's conversion, so
    the 14 forced tokens as one chunk give the token-by-token logits up to
    f32 rounding of the two paths' latent rows."""
    np.testing.assert_allclose(_forced_logits(kv_dtype, chunked=True),
                               _forced_logits(kv_dtype), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("chunk", [1, 4], ids=["token", "chunked"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("share", [False, True], ids=["own", "shared"])
def test_greedy_streams_equal_the_reference_engine(chunk, kv_dtype, share):
    checks.check_streams_equal_the_reference(_m(), chunk, kv_dtype, share)


@pytest.mark.parametrize("chunk", [1, 4], ids=["token", "chunked"])
def test_preempted_stream_equals_the_reference_engine(chunk):
    checks.check_preempt(_m(), chunk)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("chunk", [1, 4], ids=["token", "chunked"])
def test_sharing_equals_unshared_with_fewer_blocks(kv_dtype, chunk):
    """Sharing on against off on shared-prefix traffic: equal streams and
    logical blocks, strictly fewer physical blocks, a dedup ratio above 1;
    two identical prompts fork their ragged shared block (copy on write
    of ``c``, ``k_rope`` and, for int8, their scales) and still serve the
    unshared streams."""
    m = _m()
    ps = checks.prompts()
    ps = [np.concatenate([ps[0][:3].repeat(4)[:10], p]) for p in ps]
    kw = dict(prefill_chunk=chunk, kv_dtype=kv_dtype)
    if chunk > 1:
        kw["prefill_budget"] = 6
    base = checks.serve(m, False, ps, **kw)
    shared = checks.serve(m, False, ps, share_prefixes=True, **kw)
    assert checks.streams(shared) == checks.streams(base)
    sb, ss = base.stats(), shared.stats()
    assert ss["logical_blocks"] == sb["logical_blocks"]
    assert ss["physical_blocks"] < sb["physical_blocks"]
    assert ss["shared_block_hits"] > 0 and ss["block_dedup_ratio"] > 1.0
    assert sb["shared_block_hits"] == 0 and sb["cow_copies"] == 0
    block = transformer.paged_block_bytes(m.cfg, 8, kv_dtype)
    assert ss["kv_bytes_stored"] == ss["physical_blocks"] * block
    twins = [ps[1][:13], ps[1][:13].copy()]
    base = checks.serve(m, False, twins, max_new=6, **kw)
    shared = checks.serve(m, False, twins, max_new=6, share_prefixes=True,
                          **kw)
    assert checks.streams(shared) == checks.streams(base)
    assert shared.stats()["cow_copies"] >= 1


def test_cli_serves_the_reference_cli_streams(tmp_path, monkeypatch):
    checks.check_cli(_m(), tmp_path, monkeypatch,
                     ["--prefill-chunk", "4", "--prefill-budget", "8"])


@pytest.fixture(scope="module")
def mesh_1x1():
    yield from checks.one_rank_mesh()


@pytest.mark.parametrize("kw", [dict(), dict(prefill_chunk=4),
                                dict(kv_dtype="int8", share_prefixes=True,
                                     prefill_chunk=4)],
                         ids=["token", "chunked", "int8-shared-chunked"])
def test_streams_on_a_1x1_mesh_equal_unsharded_and_jax(mesh_1x1, kw):
    checks.check_one_rank_mesh(_m(), mesh_1x1, **kw)


def test_mesh_check_serves_mla_by_default():
    assert "mla" in mesh_check.SERVED
    assert dict((w[0], w[1]) for w in mesh_check.DEFAULT_WORKLOADS)[
        "mla"] == ARCH
