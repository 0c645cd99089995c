"""deepseek-moe served by the port against the JAX package.

On the deepseek-moe smoke config (3 layers: a dense first layer, then two
MoE layers of 8 experts, top 2, one shared expert), with the reference's
weights carried across by ``params_from_numpy``:

* ``decode_step_paged`` and ``prefill_step_paged``: logits of live rows and
  pool rows at rtol 1e-4, atol 1e-5 against the reference's steps, the
  bound of ``tests/test_torch_cell.py`` and ``tests/test_torch_prefill.py``
  (the port commits then attends, and computes a chunk in parallel; its
  MoE layers route each chunk row as its own group, as the reference's
  scanned cell does);
* the paged pools: one ``(n_layers, ...)`` pool a key, layer 0 the
  reference's ``first_block`` and layers 1.. its stacked blocks, and
  ``paged_block_bytes`` equal to the reference's for the full and smoke
  configs and every ``kv_dtype``;
* greedy streams, fused steps and block histories equal to
  ``repro.serve.engine``'s, token by token and chunked, on f32, bf16 and
  int8 pools, with prefix sharing on and off;
* the CLI: with the reference's weights, ``--arch deepseek-moe-16b
  --device cpu`` serves the reference CLI's streams; ``--mesh 1x2`` the
  unsharded CLI's; ``mesh_check`` serves ``moe`` by default.
"""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import mesh_check  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
ARCH = "deepseek-moe-16b"
RTOL, ATOL = 1e-4, 1e-5
_MODEL = {}


def _model():
    if not _MODEL:
        rcfg = ref_configs.get_smoke_config(ARCH)
        cfg = port_configs.get_smoke_config(ARCH)
        rp = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
        tree = jax.tree.map(np.asarray, rp)
        _MODEL["m"] = (rcfg, rp, cfg, tree,
                       transformer.params_from_numpy(tree, cfg, "cpu"))
    return _MODEL["m"]


def _ref_pools(rcache):
    """The reference's paged cache as the port's: each key's first_block
    pool stacked before its stacked blocks' pools."""
    blocks = rcache["blocks"]["slot0"]
    return {k: np.concatenate([np.asarray(rcache["first_block"][k])[None],
                               np.asarray(blocks[k])])
            for k in blocks}


def test_layers_are_first_block_then_the_stacked_blocks():
    _, _, cfg, tree, params = _model()
    assert len(params["layers"]) == cfg.n_layers == 3
    assert "ffn" in params["layers"][0] and "moe" not in params["layers"][0]
    assert all("moe" in p and "ffn" not in p for p in params["layers"][1:])
    np.testing.assert_array_equal(
        params["layers"][0]["ffn"]["wi_gate"].numpy(),
        tree["first_block"]["ffn"]["wi_gate"])
    for i in (1, 2):
        got = params["layers"][i]["moe"]
        want = tree["blocks"]["slot0"]["moe"]
        for key in ("router", "wi_gate", "wi_up", "wo"):
            np.testing.assert_array_equal(got[key].numpy(), want[key][i - 1])
        np.testing.assert_array_equal(got["shared"]["wo"].numpy(),
                                      want["shared"]["wo"][i - 1])
    assert params["layers"][1]["moe"]["router"].dtype == torch.float32
    assert [transformer.is_moe_layer(cfg, i) for i in range(3)] == \
        [False, True, True]


def test_bf16_params_keep_an_fp32_router():
    import dataclasses

    _, _, cfg, tree, _ = _model()
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    params = transformer.params_from_numpy(tree, bf16, "cpu")
    assert params["layers"][1]["moe"]["router"].dtype == torch.float32
    assert params["layers"][1]["moe"]["wi_gate"].dtype == torch.bfloat16
    own = transformer.init_lm(bf16, seed=0, device="cpu")
    assert own["layers"][2]["moe"]["router"].dtype == torch.float32
    assert own["layers"][2]["moe"]["wo"].shape == (8, 32, 64)


def test_a_tree_without_its_first_block_is_refused():
    _, _, cfg, tree, _ = _model()
    with pytest.raises(ValueError, match="parameter tree"):
        transformer.params_from_numpy(
            {k: v for k, v in tree.items() if k != "first_block"}, cfg,
            "cpu")


def _schedule(seed, B=4, max_len=32, bs=8, steps=10):
    """Per-step (tokens, positions, tables, live slots): slot 3 idle in
    the null block throughout, slot 2 admitted at step 3."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, 1 + B * max_len // bs))
    tables = perm.reshape(B, -1).astype(np.int32)
    start = [0, 0, 3, steps]
    for step in range(steps):
        live = [b for b in range(B) if step >= start[b]]
        pos = np.array([step - start[b] if b in live else 0
                        for b in range(B)], np.int32)
        bt = tables.copy()
        bt[[b for b in range(B) if b not in live]] = 0
        yield rng.integers(0, 256, (B, 1)).astype(np.int32), pos, bt, live


def test_decode_step_paged_matches_reference():
    rcfg, rp, cfg, _, params = _model()
    B, max_len, bs = 4, 32, 8
    rcache = ref_tf.init_paged_cache(rcfg, B, max_len, bs)
    cache = transformer.init_paged_cache(cfg, B, max_len, bs, "cpu")
    ref_step = jax.jit(lambda p, t, c, pos, bt: ref_tf.decode_step_paged(
        p, rcfg, t, c, pos, bt, block_size=bs))
    for tokens, pos, bt, live in _schedule(1):
        want, rcache = ref_step(rp, tokens, rcache, pos, bt)
        got, cache = transformer.decode_step_paged(
            params, cfg, torch.from_numpy(tokens), cache,
            torch.from_numpy(pos), torch.from_numpy(bt), block_size=bs)
        assert got.shape == (B, 1, cfg.vocab_padded)
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], rtol=RTOL,
                                   atol=ATOL)
        pools = _ref_pools(rcache)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy()[:, 1:],
                                       pools[key][:, 1:], rtol=RTOL,
                                       atol=ATOL)


#: (positions, lengths): slot 3 idle, slot 1 stalled in the second step,
#: rows of 1, chunks crossing block edges
CHUNK_STEPS = [([0, 0, 0, 0], [6, 3, 1, 0]),
               ([6, 3, 1, 0], [4, 0, 6, 0]),
               ([10, 3, 7, 0], [1, 2, 6, 0])]


def test_prefill_step_paged_matches_reference():
    rcfg, rp, cfg, _, params = _model()
    B, max_len, bs, C = 4, 32, 8, 6
    rng = np.random.default_rng(3)
    tables = rng.permutation(np.arange(1, 1 + B * max_len // bs)).reshape(
        B, -1).astype(np.int32)
    tables[3] = 0
    rcache = ref_tf.init_paged_cache(rcfg, B, max_len, bs)
    cache = transformer.init_paged_cache(cfg, B, max_len, bs, "cpu")
    ref_step = jax.jit(lambda p, t, c, pos, bt, lens:
                       ref_tf.prefill_step_paged(p, rcfg, t, c, pos, bt,
                                                 lens, block_size=bs))
    for pos, lens in CHUNK_STEPS:
        pos, lens = np.asarray(pos, np.int32), np.asarray(lens, np.int32)
        tokens = rng.integers(0, cfg.vocab, (B, C)).astype(np.int32)
        want, rcache = ref_step(rp, tokens, rcache, pos, tables, lens)
        got, cache = transformer.prefill_step_paged(
            params, cfg, torch.from_numpy(tokens), cache,
            torch.from_numpy(pos), torch.from_numpy(tables),
            torch.from_numpy(lens), block_size=bs)
        for b in range(B):
            np.testing.assert_allclose(
                got.numpy()[b, :lens[b]], np.asarray(want)[b, :lens[b]],
                rtol=RTOL, atol=ATOL, err_msg=f"slot {b}")
        pools = _ref_pools(rcache)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy()[:, 1:],
                                       pools[key][:, 1:], rtol=RTOL,
                                       atol=ATOL)


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_paged_pools_and_block_bytes_match_the_reference(size, kv_dtype):
    get = "get_config" if size == "full" else "get_smoke_config"
    cfg = getattr(port_configs, get)(ARCH)
    rcfg = getattr(ref_configs, get)(ARCH)
    assert transformer.paged_block_bytes(cfg, 16, kv_dtype) == \
        ref_tf.paged_block_bytes(rcfg, 16, kv_dtype)
    rcache = jax.eval_shape(lambda: ref_tf.init_paged_cache(
        rcfg, 2, 32, 16, kv_dtype=kv_dtype))
    blocks, first = rcache["blocks"]["slot0"], rcache["first_block"]
    shapes = {k: (1 + blocks[k].shape[0],) + blocks[k].shape[1:]
              for k in blocks}
    assert all(first[k].shape == blocks[k].shape[1:] for k in blocks)
    if size == "smoke":
        cache = transformer.init_paged_cache(cfg, 2, 32, 16, "cpu",
                                             kv_dtype=kv_dtype)
        assert {k: tuple(v.shape) for k, v in cache.items()} == shapes
        assert {k: str(v.dtype).split(".")[1] for k, v in cache.items()} \
            == {k: str(blocks[k].dtype) for k in blocks}
    else:
        assert shapes["k"] == (28, 1 + 2 * 2, 16, 16, 128)


# -- the engine against the JAX engine ----------------------------------------


def _prompts(seed=0, n=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(3, 14)))
            .astype(np.int32) for _ in range(n)]


def _serve(reference, prompts, **kw):
    rcfg, rp, cfg, _, params = _model()
    kw = dict(max_batch=3, max_len=48, block_size=8, **kw)
    if reference:
        eng = ref_engine.ServeEngine(rcfg, rp, scheduler="continuous", **kw)
        Req = ref_engine.Request
    else:
        eng = ServeEngine(cfg, params, device="cpu", **kw)
        Req = Request
    for uid, p in enumerate(prompts):
        eng.submit(Req(uid=uid, prompt=p.copy(), max_new_tokens=5))
    eng.run_until_drained()
    return eng


@pytest.mark.parametrize("chunk", [1, 4], ids=["token", "chunked"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("share", [False, True], ids=["own", "shared"])
def test_greedy_streams_equal_the_reference_engine(chunk, kv_dtype, share):
    prompts = _prompts()
    if share:  # a common 10-token prefix, so blocks are shared
        prompts = [np.concatenate([prompts[0][:3].repeat(4)[:10], p])
                   for p in prompts]
    kw = dict(prefill_chunk=chunk, kv_dtype=kv_dtype, share_prefixes=share)
    if chunk > 1:
        kw["prefill_budget"] = 6
    port = _serve(False, prompts, **kw)
    ref = _serve(True, prompts, **kw)
    assert ({u: r.generated for u, r in port.completed.items()}
            == {u: r.generated for u, r in ref.completed.items()})
    assert port.steps == ref.steps
    assert port.busy_slot_steps == ref.busy_slot_steps
    assert port.block_history == ref.block_history
    st, rst = port.stats(), ref.stats()
    for key in ("logical_blocks", "physical_blocks", "shared_block_hits",
                "cow_copies", "kv_bytes_served", "kv_bytes_stored"):
        assert st[key] == rst[key], key
    if share:
        assert st["shared_block_hits"] > 0


# -- the CLI and the mesh check -----------------------------------------------


def test_cli_serves_the_reference_cli_streams(tmp_path, monkeypatch, capsys):
    """With the reference's weights in place of the port's seeded init,
    the port's CLI serves the reference CLI's traffic to the same greedy
    streams, chunked here."""
    _, _, _, tree, _ = _model()

    def reference_weights(cfg, *, seed=0, device="cuda", mesh=None):
        rcfg = ref_configs.get_smoke_config(ARCH)
        return transformer.params_from_numpy(jax.tree.map(
            np.asarray, ref_steps.init_model(jax.random.PRNGKey(seed),
                                             rcfg)), cfg, device)

    argv = ["--arch", ARCH, "--requests", "4", "--max-new", "4",
            "--prefill-chunk", "4", "--prefill-budget", "8"]
    monkeypatch.setattr(serve_cli.transformer, "init_lm", reference_weights)
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    assert serve_cli.main(argv + ["--device", "cpu", "--out",
                                  str(port_out)]) == 0
    assert ref_serve.main(argv + ["--out", str(ref_out)]) == 0
    capsys.readouterr()
    got, want = (json.loads(p.read_text()) for p in (port_out, ref_out))
    assert [r["tokens"] for r in got["requests"]] == \
        [r["tokens"] for r in want["requests"]]
    assert got["stats"]["fused_steps"] == want["stats"]["fused_steps"]
    assert got["arch"] == ARCH


def test_cli_mesh_serves_the_unsharded_streams(tmp_path):
    argv = ["--arch", ARCH, "--device", "cpu", "--requests", "3",
            "--max-new", "4"]
    outs = {}
    for mesh in (None, "1x2"):
        out = tmp_path / f"{mesh}.json"
        extra = [] if mesh is None else ["--mesh", mesh]
        assert serve_cli.main(argv + extra + ["--out", str(out)]) == 0
        outs[mesh] = json.loads(out.read_text())
    assert [r["tokens"] for r in outs["1x2"]["requests"]] == \
        [r["tokens"] for r in outs[None]["requests"]]
    tp = outs["1x2"]
    assert tp["mesh"] == "1x2" and tp["mesh_backend"] == "gloo"
    assert [r["local_kv_heads"] for r in tp["mesh_ranks"]] == [2, 2]
    assert all(r["calls"] > 0 for r in tp["mesh_ranks"])


def test_mesh_check_serves_moe_by_default(tmp_path):
    assert "moe" in mesh_check.SERVED
    out = tmp_path / "verdict.json"
    assert mesh_check.main(["--device", "cpu", "--meshes", "none",
                            "--requests", "2", "--max-new", "3",
                            "--out", str(out)]) == 0
    verdict = json.loads(out.read_text())
    assert verdict["ok"] and not verdict["refused"]
    assert set(verdict["workloads"]) == set(mesh_check.SERVED)
    assert all(len(s) == 3 for s in verdict["streams"]["moe"].values())
