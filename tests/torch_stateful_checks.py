"""Checks shared by the port's SSM, hybrid and MLA serving tests
(``tests/test_torch_ssm_serve.py``, ``tests/test_torch_hybrid_serve.py``,
``tests/test_torch_mla_serve.py``): a model with mamba layers or latent
pools served by the port against the JAX package.

Each check takes a :class:`Model`, the reference's config and weights and
the port's, carried across by ``params_from_numpy``.  Tolerances: logits
and K/V pools at rtol 1e-4 and atol 1e-5 (the bound of
``tests/test_torch_cell.py``), the recurrent states at rtol 2e-4 and atol
2e-4 (the port's chunk step runs the SSD dual form where the reference
scans the recurrence; ``tests/test_ssm.py`` holds the two to this bound).
"""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import torch

import repro.configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine
from repro.train import steps as ref_steps
import repro_torch.configs as port_configs
from repro_torch.configs.base import LayerKind
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer
from repro_torch.serve.engine import Request, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5
STATE = dict(rtol=2e-4, atol=2e-4)
#: the cache's block pools (K/V, or an MLA model's latent pools) and its
#: per-slot recurrent states
POOLS = ("k", "v", "c", "k_rope")
STATES = ("ssm_state", "conv_state")


@dataclasses.dataclass
class Model:
    arch: str
    rcfg: object
    rp: object
    cfg: object
    tree: dict
    params: dict


_MODELS = {}


def model(arch, n_routed=None) -> Model:
    """The smoke config of ``arch`` (with ``n_routed`` routed experts
    where given) in both packages, the reference's seeded weights and the
    port's copy of them."""
    key = (arch, n_routed)
    if key not in _MODELS:
        rcfg = ref_configs.get_smoke_config(arch)
        cfg = port_configs.get_smoke_config(arch)
        if n_routed is not None:
            rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
                rcfg.moe, n_routed=n_routed))
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, n_routed=n_routed))
        rp = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
        tree = jax.tree.map(np.asarray, rp)
        _MODELS[key] = Model(arch, rcfg, rp, cfg, tree,
                             transformer.params_from_numpy(tree, cfg, "cpu"))
    return _MODELS[key]


def ref_as_port(rcfg, rcache) -> dict:
    """The reference's paged cache as the port's: each key's leaves of
    every layer that has it, stacked in layer order (a ``first_block``
    first, then slot ``i`` of superblock ``s`` as layer ``s *
    len(superblock) + i`` after it)."""
    out = {}
    for key, leaf in rcache.get("first_block", {}).items():
        out[key] = [np.asarray(leaf)]
    for s in range(rcfg.n_superblocks):
        for i in range(len(rcfg.superblock)):
            for key, leaf in rcache["blocks"][f"slot{i}"].items():
                out.setdefault(key, []).append(np.asarray(leaf[s]))
    return {key: np.stack(v) for key, v in out.items()}


def check_layers_follow_the_superblock(m: Model) -> None:
    cfg, tree, params = m.cfg, m.tree, m.params
    L = len(cfg.superblock)
    assert len(params["layers"]) == cfg.n_layers
    for i, p in enumerate(params["layers"]):
        kind = transformer.layer_kind(cfg, i)
        assert kind == cfg.superblock[i % L]
        mixer = "attn" if kind == LayerKind.ATTN else "mamba"
        assert mixer in p and ({"attn", "mamba"} - {mixer}).isdisjoint(p)
        sub = tree["blocks"][f"slot{i % L}"]
        for path in (("wz", "w"), ("out_proj", "w")) if mixer == "mamba" \
                else (("wq", "w"), ("wo", "w")):
            np.testing.assert_array_equal(
                p[mixer][path[0]][path[1]].numpy(),
                sub[mixer][path[0]][path[1]][i // L])
        ffn = transformer.is_moe_layer(cfg, i) or cfg.d_ff > 0
        assert ("norm2" in p) == ffn == ("norm2" in sub)
        assert ("moe" in p) == transformer.is_moe_layer(cfg, i) == \
            ("moe" in sub)
        if mixer == "mamba":
            for key in ("A_log", "D", "dt_bias"):
                assert p["mamba"][key].dtype == torch.float32
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    half = transformer.params_from_numpy(tree, bf16, "cpu")
    own = transformer.init_lm(bf16, seed=0, device="cpu")
    for p in (half, own):
        mamba = next(q["mamba"] for q in p["layers"] if "mamba" in q)
        assert mamba["A_log"].dtype == torch.float32
        assert mamba["wx"]["w"].dtype == torch.bfloat16
    assert _paths(own) == _paths(m.params)


def _paths(tree) -> list:
    out = []
    sharding.map_paths(tree, lambda path, leaf: out.append(path))
    return sorted(out)


def _schedule(seed, B=4, max_len=32, bs=8, steps=8):
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


def _check_cache(m: Model, cache, rcache, slots) -> None:
    want = ref_as_port(m.rcfg, rcache)
    assert set(want) == set(cache)
    for key in POOLS:
        if key in cache:
            np.testing.assert_allclose(cache[key].numpy()[:, 1:],
                                       want[key][:, 1:], rtol=RTOL,
                                       atol=ATOL, err_msg=key)
    for key in STATES:
        if key in cache:
            np.testing.assert_allclose(cache[key].numpy()[:, slots],
                                       want[key][:, slots], err_msg=key,
                                       **STATE)


def check_decode_step(m: Model, kv_dtype="f32") -> None:
    """A decode step advances the states of live and idle slots alike, as
    the reference's (``active`` all true); live slots are compared.  An
    idle slot's row attends over the null block, where the port reads the
    rows other idle slots committed and the reference merges its own
    fresh row, so its state moves differently: admission zeroes it in both,
    as the engines do."""
    B, max_len, bs = 4, 32, 8
    rcache = ref_tf.init_paged_cache(m.rcfg, B, max_len, bs,
                                     kv_dtype=kv_dtype)
    cache = transformer.init_paged_cache(m.cfg, B, max_len, bs, "cpu",
                                         kv_dtype=kv_dtype)
    ref_step = jax.jit(lambda p, t, c, pos, bt: ref_tf.decode_step_paged(
        p, m.rcfg, t, c, pos, bt, block_size=bs, kv_dtype=kv_dtype))
    admitted = set()
    for tokens, pos, bt, live in _schedule(1):
        mask = np.array([b in live and b not in admitted for b in range(B)])
        admitted |= set(live)
        rcache = ref_tf.reset_paged_slots(rcache, mask)
        transformer.reset_paged_slots(cache, mask)
        want, rcache = ref_step(m.rp, tokens, rcache, pos, bt)
        got, cache = transformer.decode_step_paged(
            m.params, m.cfg, torch.from_numpy(tokens), cache,
            torch.from_numpy(pos), torch.from_numpy(bt), block_size=bs,
            kv_dtype=kv_dtype)
        assert got.shape == (B, 1, m.cfg.vocab_padded)
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live], rtol=RTOL,
                                   atol=ATOL)
        if kv_dtype == "f32" or not set(POOLS) & set(cache):
            _check_cache(m, cache, rcache, live)


#: (positions, lengths): slot 3 idle, slot 1 stalled in the second step,
#: rows of 1, chunks crossing block edges
CHUNK_STEPS = [([0, 0, 0, 0], [6, 3, 1, 0]),
               ([6, 3, 1, 0], [4, 0, 6, 0]),
               ([10, 3, 7, 0], [1, 2, 6, 0])]


def check_prefill_step(m: Model) -> None:
    """A chunk step against the reference's scanned cell: live rows'
    logits, the pools, and the states of every slot (a slot fed nothing
    keeps its state)."""
    B, max_len, bs, C = 4, 32, 8, 6
    rng = np.random.default_rng(3)
    tables = rng.permutation(np.arange(1, 1 + B * max_len // bs)).reshape(
        B, -1).astype(np.int32)
    tables[3] = 0
    rcache = ref_tf.init_paged_cache(m.rcfg, B, max_len, bs)
    cache = transformer.init_paged_cache(m.cfg, B, max_len, bs, "cpu")
    ref_step = jax.jit(lambda p, t, c, pos, bt, lens:
                       ref_tf.prefill_step_paged(p, m.rcfg, t, c, pos, bt,
                                                 lens, block_size=bs))
    for pos, lens in CHUNK_STEPS:
        pos, lens = np.asarray(pos, np.int32), np.asarray(lens, np.int32)
        tokens = rng.integers(0, m.cfg.vocab, (B, C)).astype(np.int32)
        before = {k: v.clone() for k, v in cache.items()}
        want, rcache = ref_step(m.rp, tokens, rcache, pos, tables, lens)
        got, cache = transformer.prefill_step_paged(
            m.params, m.cfg, torch.from_numpy(tokens), cache,
            torch.from_numpy(pos), torch.from_numpy(tables),
            torch.from_numpy(lens), block_size=bs)
        for b in range(B):
            np.testing.assert_allclose(
                got.numpy()[b, :lens[b]], np.asarray(want)[b, :lens[b]],
                rtol=RTOL, atol=ATOL, err_msg=f"slot {b}")
        _check_cache(m, cache, rcache, list(range(B)))
        for b in np.flatnonzero(lens == 0):
            for key in STATES:
                if key in cache:
                    assert torch.equal(cache[key][:, b], before[key][:, b])


def check_pools_and_block_bytes(arch, size, kv_dtype) -> None:
    get = "get_config" if size == "full" else "get_smoke_config"
    cfg = getattr(port_configs, get)(arch)
    rcfg = getattr(ref_configs, get)(arch)
    assert transformer.paged_block_bytes(cfg, 16, kv_dtype) == \
        ref_tf.paged_block_bytes(rcfg, 16, kv_dtype)
    rcache = jax.eval_shape(lambda: ref_tf.init_paged_cache(
        rcfg, 2, 32, 16, kv_dtype=kv_dtype))
    want = {}
    for s in range(rcfg.n_superblocks):
        for i in range(len(rcfg.superblock)):
            for key, leaf in rcache["blocks"][f"slot{i}"].items():
                n, shape = want.get(key, (0, leaf.shape[1:]))
                want[key] = (n + 1, shape)
    shapes = {key: (n,) + tuple(shape) for key, (n, shape) in want.items()}
    dtypes = {key: str(rcache["blocks"][f"slot{i}"][key].dtype)
              for i in range(len(rcfg.superblock))
              for key in rcache["blocks"][f"slot{i}"]}
    if size == "smoke":
        cache = transformer.init_paged_cache(cfg, 2, 32, 16, "cpu",
                                             kv_dtype=kv_dtype)
        assert {k: tuple(v.shape) for k, v in cache.items()} == shapes
        assert {k: str(v.dtype).split(".")[1] for k, v in cache.items()} \
            == dtypes
    else:
        s = cfg.ssm
        assert shapes["ssm_state"] == (
            sum(k == LayerKind.MAMBA for k in cfg.superblock)
            * cfg.n_superblocks, 2, s.n_heads(cfg.d_model), s.d_state,
            s.head_dim)


def check_copy_and_reset(m: Model) -> None:
    """``copy_paged_block`` copies K/V blocks only and leaves the states;
    ``reset_paged_slots`` zeroes both states of the named slots only."""
    cache = transformer.init_paged_cache(m.cfg, 3, 16, 8, "cpu",
                                         kv_dtype="int8")
    gen = torch.Generator().manual_seed(0)
    for v in cache.values():
        v.copy_(torch.randint(-100, 100, v.shape, generator=gen).to(v.dtype))
    before = {k: v.clone() for k, v in cache.items()}
    assert transformer.copy_paged_block(cache, 2, 5) is cache
    for key, v in cache.items():
        if key in ("ssm_state", "conv_state"):
            assert torch.equal(v, before[key])
        else:
            assert torch.equal(v[:, 5], before[key][:, 2])
            keep = [b for b in range(v.shape[1]) if b != 5]
            assert torch.equal(v[:, keep], before[key][:, keep])
    mask = np.array([True, False, True])
    assert transformer.reset_paged_slots(cache, mask) is cache
    for key, v in cache.items():
        if key in ("ssm_state", "conv_state"):
            assert not v[:, [0, 2]].any()
            assert torch.equal(v[:, 1], before[key][:, 1])
    transformer.reset_paged_slots(cache, torch.tensor([False, True, False]))
    assert not cache["ssm_state"].any() and not cache["conv_state"].any()


def prompts(seed=0, n=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(rng.integers(3, 14)))
            .astype(np.int32) for _ in range(n)]


def serve(m: Model, reference, prompts, hook=None, mesh=None, max_new=5,
          **kw):
    kw = {**dict(max_batch=3, max_len=48, block_size=8), **kw}
    if reference:
        eng = ref_engine.ServeEngine(m.rcfg, m.rp, scheduler="continuous",
                                     **kw)
        Req = ref_engine.Request
    else:
        params = (m.params if mesh is None else transformer.params_from_numpy(
            m.tree, m.cfg, "cpu", mesh=mesh))
        eng = ServeEngine(m.cfg, params, device="cpu", mesh=mesh, **kw)
        Req = Request
    if hook is not None:
        eng.add_step_hook(hook)
    for uid, p in enumerate(prompts):
        eng.submit(Req(uid=uid, prompt=p.copy(), max_new_tokens=max_new))
    eng.run_until_drained()
    return eng


def streams(eng) -> dict:
    return {u: [int(t) for t in r.generated]
            for u, r in eng.completed.items()}


def check_streams_equal_the_reference(m: Model, chunk, kv_dtype, share):
    ps = prompts()
    if share:  # a common 10-token prefix, so blocks are shared
        ps = [np.concatenate([ps[0][:3].repeat(4)[:10], p]) for p in ps]
    kw = dict(prefill_chunk=chunk, kv_dtype=kv_dtype, share_prefixes=share)
    if chunk > 1:
        kw["prefill_budget"] = 6
    port = serve(m, False, ps, **kw)
    ref = serve(m, True, ps, **kw)
    assert streams(port) == streams(ref)
    assert port.steps == ref.steps
    assert port.busy_slot_steps == ref.busy_slot_steps
    assert port.block_history == ref.block_history
    st, rst = port.stats(), ref.stats()
    for key in ("logical_blocks", "physical_blocks", "shared_block_hits",
                "cow_copies", "kv_bytes_served", "kv_bytes_stored",
                "block_dedup_ratio"):
        assert st[key] == rst[key], key
    if share:
        assert st["shared_block_hits"] > 0
    return port


def check_preempt(m: Model, chunk) -> None:
    """A request preempted mid-stream is re-admitted to a slot another
    request's state has moved, replays, and serves the stream it serves
    unpreempted, as the JAX engine does under the same hook."""
    ps = prompts(4, n=5)
    kw = dict(prefill_chunk=chunk, max_batch=2)
    if chunk > 1:
        kw["prefill_budget"] = 6

    def hook_for(fired):
        def hook(engine, busy):
            for r in engine._live["slot_req"]:
                if (not fired and r is not None and r.uid == 1
                        and len(r.generated) == 2):
                    fired.append(engine.preempt(uid=1))
            return False
        return hook

    base = serve(m, False, ps, max_new=6, **kw)
    runs = {}
    for reference in (False, True):
        fired = []
        runs[reference] = serve(m, reference, ps, hook=hook_for(fired),
                                max_new=6, **kw)
        assert fired == [1] and runs[reference].preemptions == 1
    assert streams(runs[False]) == streams(base) == streams(runs[True])
    assert runs[False].steps == runs[True].steps


def check_cli(m: Model, tmp_path, monkeypatch, argv) -> None:
    """With the reference's weights in place of the port's seeded init,
    the port's CLI serves the reference CLI's traffic to the same greedy
    streams."""
    def reference_weights(cfg, *, seed=0, device="cuda", mesh=None):
        return transformer.params_from_numpy(jax.tree.map(
            np.asarray, ref_steps.init_model(jax.random.PRNGKey(seed),
                                             m.rcfg)), cfg, device)

    argv = ["--arch", m.arch, "--requests", "4", "--max-new", "4"] + argv
    monkeypatch.setattr(serve_cli.transformer, "init_lm", reference_weights)
    port_out, ref_out = tmp_path / "port.json", tmp_path / "ref.json"
    assert serve_cli.main(argv + ["--device", "cpu", "--out",
                                  str(port_out)]) == 0
    assert ref_serve.main(argv + ["--out", str(ref_out)]) == 0
    got, want = (json.loads(p.read_text()) for p in (port_out, ref_out))
    assert [r["tokens"] for r in got["requests"]] == \
        [r["tokens"] for r in want["requests"]]
    assert got["stats"]["fused_steps"] == want["stats"]["fused_steps"]
    assert got["arch"] == m.arch


def one_rank_mesh():
    """A one-rank gloo group in this process and its 1x1 mesh (a
    generator for a module-scoped fixture)."""
    import torch.distributed as dist

    mesh_mod.init_rank(0, 1, mesh_mod.free_port(), "gloo", timeout=60)
    try:
        yield mesh_mod.make_serve_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def check_one_rank_mesh(m: Model, mesh, **kw) -> None:
    ps = prompts(2, n=4)
    base = serve(m, False, ps, **kw)
    got = serve(m, False, ps, mesh=mesh, **kw)
    ref = serve(m, True, ps, **kw)
    assert streams(got) == streams(base) == streams(ref)
    st = got.stats()
    assert st["mesh"] == "1x1" and st["mesh_devices"] == 1


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def mesh_verdict(m: Model, name, tmp_path, requests=3, max_new=6) -> dict:
    """The mesh check on the CPU over none, 1x1, 2x1, 1x2 and 2x2 for the
    workload ``name``, on the reference's weights."""
    np.savez(tmp_path / f"{m.arch}.npz", **_flat(m.tree))
    out = tmp_path / "verdict.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.serve.mesh_check", "--device",
         "cpu", "--meshes", "none,1x1,2x1,1x2,2x2", "--workloads", name,
         "--requests", str(requests), "--max-new", str(max_new),
         "--weights", str(tmp_path), "--out", str(out)],
        capture_output=True, text=True, env=env, timeout=400)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(out.read_text())


def jax_mesh_check_streams(m: Model, requests=3, max_new=6) -> dict:
    """The JAX unsharded engine on the mesh check's traffic."""
    eng = ref_engine.ServeEngine(m.rcfg, m.rp, max_batch=2, max_len=64,
                                 scheduler="continuous", block_size=8)
    rng = np.random.default_rng(0)
    for uid in range(requests):
        p = rng.integers(0, m.rcfg.vocab, size=int(rng.integers(3, 10))
                         ).astype(np.int32)
        eng.submit(ref_engine.Request(uid=uid, prompt=p,
                                      max_new_tokens=max_new))
    return {str(u): [int(t) for t in r.generated]
            for u, r in eng.run_until_drained().items()}


def check_mesh_verdict(m: Model, name, verdict) -> None:
    assert verdict["ok"], verdict["diffs"]
    assert verdict["shapes"] == ["none", "1x1", "2x1", "1x2", "2x2"]
    per = verdict["workloads"][name]
    assert len({d["digest"] for d in per.values()}) == 1, per
    assert verdict["streams"][name] == jax_mesh_check_streams(m)
    for shape in ("2x1", "1x2", "2x2"):
        ranks = per[shape]["ranks"]
        assert len(ranks) == per[shape]["mesh_devices"]
        assert all(r["calls"] > 0 for r in ranks)
