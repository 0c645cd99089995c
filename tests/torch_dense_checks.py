"""Checks shared by the port's dense-path and wave-scheduler tests
(``tests/test_torch_dense_serve*.py``, ``tests/test_torch_wave*.py``): the
port's ``init_cache``, ``forward``, ``prefill`` and ``decode_step`` and its
wave engine, held against the JAX package on the reference's weights.

Tolerances: logits and cache rows at rtol 1e-4 and atol 1e-5 (the bound
of ``tests/test_torch_cell.py``), recurrent states at rtol 2e-4 and atol
2e-4 (the port's reference for the two SSD orders, as in
``tests/torch_stateful_checks.py``), and a decode loop against the
port's own ``forward`` at the reference's 2e-3
(``tests/test_serving_consistency.py``).  Streams, fused steps, busy
slot-steps and TTFT steps are held exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import transformer as ref_tf
from repro.serve import engine as ref_engine
from repro_torch.configs.base import LayerKind
from repro_torch.models import attention, transformer
from repro_torch.serve.engine import Request, ServeEngine
from torch_stateful_checks import ATOL, RTOL, STATE, model, ref_as_port

#: the reference's forward-vs-decode bound
CONSISTENCY = dict(rtol=2e-3, atol=2e-3)
#: the reference's serving-consistency shapes
B, S = 2, 12
#: stats() keys that read the host's clock
WALL_KEYS = ("wall_s", "tok_s", "p50_latency_s", "p95_latency_s",
             "ttft_p50_s", "ttft_p95_s")
SEQ_KEYS = ("k", "v", "c", "k_rope")
STATE_KEYS = ("ssm_state", "conv_state")


def dropless(cfg):
    """``cfg`` with MoE capacity high enough that nothing drops (the
    reference's ``tests/conftest.py`` rule); the weights are the same."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=64.0))


def tokens(cfg, seed=1, shape=(B, S)) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _ref_dense_as_port(rcfg, rcache) -> dict:
    return ref_as_port(rcfg, {k: v for k, v in rcache.items()
                              if k != "pos"})


def check_init_cache(arch) -> None:
    """Every leaf of the reference's dense cache, as the port lays it out
    (a stack a kind in layer order), has the port's shape and dtype."""
    m = model(arch)
    want = _ref_dense_as_port(m.rcfg, ref_tf.init_cache(m.rcfg, B, S))
    got = transformer.init_cache(m.cfg, B, S, "cpu")
    assert got.pop("pos") == 0
    assert set(got) == set(want)
    for key, leaf in got.items():
        assert tuple(leaf.shape) == want[key].shape, key
        assert str(leaf.dtype).replace("torch.", "") == str(
            want[key].dtype), key
        assert not leaf.any(), key
    n_attn = transformer.count_layers(m.cfg, LayerKind.ATTN)
    for key in set(got) & set(SEQ_KEYS):  # a layer's slice is contiguous
        assert got[key].shape[0] == n_attn
        assert all(got[key][j].is_contiguous() for j in range(n_attn))


def check_forward(arch) -> None:
    m = model(arch)
    tok = tokens(m.cfg)
    want, want_aux = ref_tf.forward(m.rp, m.rcfg, jnp.asarray(tok))
    got, aux = transformer.forward(m.params, m.cfg, torch.from_numpy(tok))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=RTOL,
                               atol=ATOL)


def check_prefill(arch) -> None:
    m = model(arch)
    tok = tokens(m.cfg)
    want, rcache = ref_tf.prefill(m.rp, m.rcfg, jnp.asarray(tok))
    got, cache = transformer.prefill(m.params, m.cfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    assert cache.pop("pos") == int(rcache["pos"]) == S
    ref = _ref_dense_as_port(m.rcfg, rcache)
    assert set(cache) == set(ref)
    for key, leaf in cache.items():
        tol = STATE if key in STATE_KEYS else dict(rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(leaf.numpy(), ref[key], err_msg=key,
                                   **tol)


def _counting(monkeypatch) -> list:
    """Count the dense decode's calls of the contiguous flash-decode
    wrapper (the kernel on CUDA, its plain version here)."""
    calls = []
    inner = attention.flash_decode

    def counted(*args, **kw):
        calls.append(args[1].shape)
        return inner(*args, **kw)

    monkeypatch.setattr(attention, "flash_decode", counted)
    return calls


def check_decode_loop(arch, monkeypatch) -> None:
    """A decode loop from an empty cache: every position's logits equal
    the JAX ``decode_step``'s at the cell bound and the port's own
    ``forward`` at the reference's 2e-3, on dropless MoE configs (the
    reference's consistency rule); the caches and states after the loop
    equal the reference's; each step calls the contiguous flash-decode
    wrapper once a grouped-query attention layer (none for MLA and
    mamba layers)."""
    m = model(arch)
    rcfg, cfg = dropless(m.rcfg), dropless(m.cfg)
    tok = tokens(cfg)
    full, _ = transformer.forward(m.params, cfg, torch.from_numpy(tok))
    rcache = ref_tf.init_cache(rcfg, B, S)
    cache = transformer.init_cache(cfg, B, S, "cpu")
    step = jax.jit(lambda p, t, c: ref_tf.decode_step(p, rcfg, t, c))
    calls = _counting(monkeypatch)
    got, want = [], []
    for i in range(S):
        r, rcache = step(m.rp, jnp.asarray(tok[:, i:i + 1]), rcache)
        logits, out = transformer.decode_step(
            m.params, cfg, torch.from_numpy(tok[:, i:i + 1]), cache)
        assert out is cache and cache["pos"] == i + 1
        got.append(logits[:, 0].numpy())
        want.append(np.asarray(r[:, 0]))
    got, want = np.stack(got, 1), np.stack(want, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, full.numpy(), **CONSISTENCY)
    ref = _ref_dense_as_port(rcfg, rcache)
    for key in set(cache) - {"pos"}:
        tol = STATE if key in STATE_KEYS else dict(rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(cache[key].numpy(), ref[key],
                                   err_msg=key, **tol)
    gqa = 0 if cfg.mla is not None else transformer.count_layers(
        cfg, LayerKind.ATTN)
    assert len(calls) == gqa * S
    assert all(shape == (B, S, cfg.n_kv_heads, cfg.head_dim)
               for shape in calls)


#: the traffic of the reference's golden-equivalence test: seed 9, six
#: prompts of 4-16 tokens, 6 new tokens, 2 slots, max_len 64, blocks of 8
WAVE_KW = dict(max_batch=2, max_len=64, block_size=8)


def wave_prompts(vocab, seed=9, n=6):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(4, 17)))
            .astype(np.int32) for _ in range(n)]


def serve(engine, request_cls, prompts, max_new=6):
    for uid, p in enumerate(prompts):
        engine.submit(request_cls(uid=uid, prompt=p.copy(),
                                  max_new_tokens=max_new))
    engine.run_until_drained()
    return engine


def summary(engine) -> dict:
    """What two engines on the same traffic must agree on: streams, fused
    and busy slot-steps, each request's TTFT steps, and every stats() key
    that does not read the host's clock."""
    stats = {k: v for k, v in engine.stats().items() if k not in WALL_KEYS}
    return {"streams": {u: r.generated for u, r in engine.completed.items()},
            "steps": engine.steps, "busy": engine.busy_slot_steps,
            "ttft_steps": {u: r.ttft_steps
                           for u, r in engine.completed.items()},
            "stats": stats}


def check_wave(arch, tight_moe: bool = False) -> None:
    """The port's wave engine equals the JAX wave engine on the
    reference's traffic (streams, steps, busy slot-steps, TTFT steps,
    stats), and the port's continuous engine serves the same streams in
    no more steps.  MoE layers route as the reference's do: with the
    config's capacity (``tight_moe``, drops included) or dropless."""
    m = model(arch)
    rcfg, cfg = ((m.rcfg, m.cfg) if tight_moe
                 else (dropless(m.rcfg), dropless(m.cfg)))
    prompts = wave_prompts(cfg.vocab)
    want = summary(serve(ref_engine.ServeEngine(
        rcfg, m.rp, scheduler="wave", **WAVE_KW), ref_engine.Request,
        prompts))
    wave = summary(serve(ServeEngine(cfg, m.params, scheduler="wave",
                                     device="cpu", **WAVE_KW), Request,
                         prompts))
    assert wave == want
    waves = [prompts[i:i + 2] for i in range(0, len(prompts), 2)]
    assert wave["steps"] == sum(max(len(p) for p in w) + 6 - 1
                                for w in waves)
    cont = summary(serve(ServeEngine(cfg, m.params, device="cpu",
                                     **WAVE_KW), Request, prompts))
    assert cont["streams"] == wave["streams"]
    assert cont["steps"] < wave["steps"]


def check_decode_module(arch) -> None:
    """The dense one-token decode of one attention layer (GQA's
    ``attention_decode``, MLA's ``mla_decode_dense``) against the
    reference's, with ``pos`` a (B,) vector of per-slot lengths and with
    a host int: equal outputs, and the new row committed at ``pos`` equal
    to the reference's returned slice (the reference leaves the cache to
    its caller)."""
    from repro.models import attention as ref_attn, mla as ref_mla
    from repro_torch.models import mla

    m = model(arch)
    cfg = m.cfg
    j = next(i for i, (kind, _) in enumerate(transformer.layer_pools(cfg))
             if kind == LayerKind.ATTN)
    p = m.params["layers"][j]
    tree = m.tree.get("first_block") or {
        k: jax.tree.map(lambda a: a[j // len(cfg.superblock)], v)
        for k, v in m.tree["blocks"][f"slot{j % len(cfg.superblock)}"]
        .items()}
    rng = np.random.default_rng(5)
    Bn, Sn = 3, 10
    x = rng.standard_normal((Bn, 1, cfg.d_model)).astype(np.float32)
    if cfg.mla is not None:
        ml = cfg.mla
        caches = [rng.standard_normal((Bn, Sn, w)).astype(np.float32)
                  for w in (ml.kv_lora_rank, ml.qk_rope_dim)]
    else:
        caches = [rng.standard_normal(
            (Bn, Sn, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
            for _ in range(2)]
    for pos in (np.array([0, 4, 9], np.int32), 6):
        if cfg.mla is not None:
            want, *rows = ref_mla.mla_decode(tree["mla"], m.rcfg,
                                             jnp.asarray(x), *map(
                                                 jnp.asarray, caches), pos)
        else:
            want, *rows = ref_attn.attention_decode(
                tree["attn"], m.rcfg, jnp.asarray(x),
                *map(jnp.asarray, caches), pos)
        got_caches = [torch.from_numpy(c.copy()) for c in caches]
        tpos = torch.from_numpy(pos) if isinstance(pos, np.ndarray) else pos
        fn = (mla.mla_decode_dense if cfg.mla is not None
              else attention.attention_decode)
        got = fn(p["mla" if cfg.mla is not None else "attn"], cfg,
                 torch.from_numpy(x), *got_caches, tpos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
        at = np.broadcast_to(np.asarray(pos), (Bn,))
        for c, new in zip(got_caches, rows):
            np.testing.assert_allclose(c.numpy()[np.arange(Bn), at],
                                       np.asarray(new)[:, 0], rtol=RTOL,
                                       atol=ATOL)
