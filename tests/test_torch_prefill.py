"""Chunked prefill in the port against ``repro``'s.

Three layers, held against the reference on the CPU:

* kernel: the plain ``flash_prefill_paged_ref`` (which the wrapper runs
  for CPU tensors) against the Pallas ``flash_prefill_paged`` in interpret
  mode and the oracle ``prefill_paged_ref``, on shuffled block tables with
  ragged, unaligned chunks.  Output rows below ``q_len`` at 3e-5 (1e-5
  against the oracle, which is the same dense fp32 softmax); committed
  pools bit-equal through the tables, since a commit is a copy; rows past
  ``q_len`` zero; blocks no table names untouched.
* model: the port's ``prefill_step_paged`` against the reference's, with
  the reference's weights (``params_from_numpy``), ragged lengths
  including 0 and 1 and non-zero positions.  Logit rows below
  ``lengths[b]`` and pool rows at rtol 1e-4, atol 1e-5, the tolerance of
  ``tests/test_torch_cell.py``: not bitwise, because the port computes the
  chunk in parallel where the reference scans its one-token cell.
* engine: the port's chunked engine against the JAX chunked engine, with
  equal greedy streams, step counts, busy slot-steps, block histories and
  step-clock TTFTs; chunk sweeps, budgets, preemption and EOS inside the
  port, mirroring ``tests/test_prefill.py`` and
  ``tests/test_serve_engine.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.kernels.flash_decode import kernel as ref_kernel  # noqa: E402
from repro.kernels.flash_decode import ref as ref_oracle  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.kernels.flash_decode import kernel, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve import engine as port_engine  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
RTOL, ATOL = 1e-4, 1e-5


# ---------------------------------------------------------------------------
# kernel: plain version vs the Pallas kernel and the oracle
# ---------------------------------------------------------------------------


def _prefill_inputs(B, C, KV, G, D, bs, nb, q_start, q_len, seed=0,
                    spare=2):
    """numpy q, chunk K/V, pools with ``spare`` blocks no table names
    besides the null block 0, a shuffled table, and the given q_start and
    q_len."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * nb + spare
    q = rng.standard_normal((B, C, KV, G, D)).astype(np.float32)
    k_new, v_new = (rng.standard_normal((B, C, KV, D)).astype(np.float32)
                    for _ in range(2))
    k_pool, v_pool = (rng.standard_normal((n_blocks, bs, KV, D))
                      .astype(np.float32) for _ in range(2))
    bt = rng.permutation(np.arange(1, n_blocks))[: B * nb].reshape(B, nb)
    return (q, k_new, v_new, k_pool, v_pool, bt.astype(np.int32),
            np.asarray(q_start, np.int32), np.asarray(q_len, np.int32))


def _torch(*arrays):
    """Private torch copies: the port commits into its pools in place."""
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


PREFILL_CASES = [
    # B, C, KV, G, D, bs, nb, q_start, q_len, block_c of the Pallas kernel
    (2, 8, 2, 1, 16, 8, 4, [0, 13], [8, 0], 8),        # G 1, a slot fed 0
    (3, 6, 1, 2, 16, 4, 6, [4, 0, 9], [6, 1, 5], 2),   # chunks cross blocks
    (2, 8, 2, 3, 16, 8, 3, [3, 16], [5, 8], 4),        # G 3, up to the end
    (1, 16, 2, 2, 32, 16, 2, [7], [16], 8),
]


@pytest.mark.parametrize("B,C,KV,G,D,bs,nb,q_start,q_len,bc", PREFILL_CASES)
def test_plain_prefill_matches_pallas_kernel_and_oracle(
        B, C, KV, G, D, bs, nb, q_start, q_len, bc):
    arrays = _prefill_inputs(B, C, KV, G, D, bs, nb, q_start, q_len)
    t = _torch(*arrays)
    out = kernel.flash_prefill_paged(*t).numpy()
    kp, vp = t[3].numpy(), t[4].numpy()
    jx = [jnp.asarray(a) for a in arrays]
    pallas, kp_pl, vp_pl = ref_kernel.flash_prefill_paged(
        *jx, block_c=bc, interpret=True)
    oracle, kp_or, vp_or = ref_oracle.prefill_paged_ref(*jx)
    for b in range(B):
        n = q_len[b]
        np.testing.assert_allclose(out[b, :n], np.asarray(oracle)[b, :n],
                                   rtol=1e-5, atol=1e-5, err_msg=f"slot {b}")
        np.testing.assert_allclose(out[b, :n], np.asarray(pallas)[b, :n],
                                   rtol=3e-5, atol=3e-5, err_msg=f"slot {b}")
        assert not out[b, n:].any(), f"slot {b}: rows past q_len not zero"
    bt = arrays[5]
    for got, want in ((kp, kp_pl), (vp, vp_pl), (kp, kp_or), (vp, vp_or)):
        np.testing.assert_array_equal(got[bt], np.asarray(want)[bt])
    for blk in sorted(set(range(len(kp))) - set(bt.ravel().tolist())):
        np.testing.assert_array_equal(kp[blk], arrays[3][blk])
        np.testing.assert_array_equal(vp[blk], arrays[4][blk])


def test_plain_prefill_bf16_matches_oracle():
    """bf16 q, chunk and pools: the same commit (a copy, bit-equal) and
    fp32 softmax, cast back; within one bf16 rounding of the JAX oracle."""
    arrays = _prefill_inputs(2, 8, 2, 2, 16, 8, 4, [5, 0], [8, 3], seed=2)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:5]]
    idx = _torch(*arrays[5:])
    out = kernel.flash_prefill_paged(*bf, *idx)
    assert out.dtype == torch.bfloat16
    jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (torch.from_numpy(a).to(torch.bfloat16)
                    for a in arrays[:5])]
    want, kp_or, _ = ref_oracle.prefill_paged_ref(
        *jx, *[jnp.asarray(a) for a in arrays[5:]])
    for b, n in enumerate(arrays[7]):
        np.testing.assert_allclose(
            out[b, :n].float().numpy(),
            np.asarray(want.astype(jnp.float32))[b, :n], rtol=1e-2, atol=1e-2)
    bt = arrays[5]
    np.testing.assert_array_equal(bf[3].float().numpy()[bt],
                                  np.asarray(kp_or.astype(jnp.float32))[bt])


def test_plain_prefill_stale_rows_are_inert():
    """Garbage at positions past each slot's chunk frontier (recycled
    blocks, an earlier tenant's rows) cannot reach a committed row."""
    B, C, KV, G, D, bs, nb = 2, 8, 2, 2, 16, 4, 6
    arrays = _prefill_inputs(B, C, KV, G, D, bs, nb, [3, 10], [5, 8], seed=5)
    out1 = kernel.flash_prefill_paged(*_torch(*arrays))
    q, kn, vn, kp, vp, bt, qs, ql = arrays
    kp2, vp2 = kp.copy(), vp.copy()
    for b in range(B):
        for p in range(qs[b] + ql[b], nb * bs):
            kp2[bt[b, p // bs], p % bs] = 99.0
            vp2[bt[b, p // bs], p % bs] = -99.0
    out2 = kernel.flash_prefill_paged(*_torch(q, kn, vn, kp2, vp2, bt, qs,
                                              ql))
    torch.testing.assert_close(out1, out2, rtol=1e-6, atol=1e-6)


def test_padded_rows_past_the_table_are_not_committed():
    """A slot near the end of its table with a short chunk in a wide
    bucket: its padded rows' positions run past the table; they are
    clamped, never committed, and come out as zeros."""
    B, C, KV, G, D, bs, nb = 1, 8, 1, 1, 16, 4, 2
    arrays = _prefill_inputs(B, C, KV, G, D, bs, nb, [6], [2], seed=6)
    t = _torch(*arrays)
    out = kernel.flash_prefill_paged(*t)
    assert not out[0, 2:].any()
    kp, bt = t[3].numpy(), arrays[5]
    changed = {(int(blk), row) for blk in range(len(kp)) for row in range(bs)
               if not np.array_equal(kp[blk, row], arrays[3][blk, row])}
    assert changed == {(int(bt[0, 1]), 2), (int(bt[0, 1]), 3)}


def test_plain_prefill_with_commit_rows_given_is_the_same_call():
    """Passing ``commit_rows`` of the inputs (what a timing loop does, to
    keep the call free of device waits) changes neither the output nor
    the committed pools."""
    arrays = _prefill_inputs(3, 6, 1, 2, 16, 4, 6, [4, 0, 9], [6, 1, 0])
    t1, t2 = _torch(*arrays), _torch(*arrays)
    rows = ref.commit_rows(t2[5], t2[6], t2[7], 6, 4)
    assert rows[0].tolist() == list(range(6)) + [6]
    out1 = ref.flash_prefill_paged_ref(*t1)
    out2 = ref.flash_prefill_paged_ref(*t2, rows=rows)
    assert torch.equal(out1, out2)
    assert torch.equal(t1[3], t2[3]) and torch.equal(t1[4], t2[4])


def test_cpu_prefill_wrapper_leaves_the_launch_counter_at_zero():
    kernel.flash_prefill_paged(*_torch(*_prefill_inputs(
        1, 4, 1, 1, 16, 4, 2, [0], [4])))
    assert kernel.flash_prefill_paged.launches == 0


@pytest.mark.parametrize("bad", [
    "q_rank", "k_new_shape", "v_new_dtype", "pool_dtype", "table_dtype",
    "q_len_shape", "non_contiguous", "float16",
])
def test_prefill_wrapper_rejects_malformed_inputs(bad):
    q, kn, vn, kp, vp, bt, qs, ql = _torch(*_prefill_inputs(
        2, 4, 2, 2, 16, 4, 3, [0, 2], [4, 1]))
    if bad == "q_rank":
        q = q[0]
    elif bad == "k_new_shape":
        kn = kn[:, :2]
    elif bad == "v_new_dtype":
        vn = vn.double()
    elif bad == "pool_dtype":
        kp = kp.double()
    elif bad == "table_dtype":
        bt = bt.long()
    elif bad == "q_len_shape":
        ql = ql[:1]
    elif bad == "non_contiguous":
        q = q.transpose(3, 4)
    elif bad == "float16":
        q, kn, vn, kp, vp = (x.half() for x in (q, kn, vn, kp, vp))
    with pytest.raises((ValueError, TypeError)):
        kernel.flash_prefill_paged(q, kn, vn, kp, vp, bt, qs, ql)


def test_prefill_work_terms_count_each_byte_once():
    """Rows below q_len of q and k/v_new, the same rows committed, the
    K/V rows already cached (q_start rows; none for a slot fed nothing)
    read once, the table entries the cached and new rows need,
    q_start/q_len and the whole output; flops 4 per (query row, causal
    key) pair, head and element."""
    B, C, KV, G, D, bs, nb = 3, 8, 2, 2, 64, 16, 4
    q = torch.zeros((B, C, KV, G, D), dtype=torch.bfloat16)
    k_pool = torch.zeros((1 + B * nb, bs, KV, D), dtype=torch.bfloat16)
    bt = torch.zeros((B, nb), dtype=torch.int32)
    t = ref.prefill_work_terms(q, k_pool, bt, [16, 0, 40], [8, 3, 0])
    rows, cached, tiles = 8 + 3, 16 + 0, 2 + 1
    assert t["bytes"] == ((rows + B * C) * KV * G * D * 2
                          + 4 * rows * KV * D * 2 + 2 * cached * KV * D * 2
                          + 4 * tiles + 8 * B)
    pairs = (16 * 8 + 36) + (0 + 6)
    assert t["flops"] == 4.0 * pairs * KV * G * D


def test_prefill_rows_per_block_fit_the_shared_memory():
    """The attention plan's rows a block (64 query vectors over G, at most
    C) and its shared memory, within an H100 block's 227 KB, and a raise
    for a shape that does not fit."""
    bf16, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    plan = kernel.prefill_plan(64, 2, 128, 16, 64, bf16, bf16)
    assert (plan.rows, plan.key_tile, plan.route) == (32, 64, "mma")
    assert plan.smem == (64 + 4 * 64) * (2 * 128 + 16) + 4 * 64
    assert kernel.prefill_plan(4, 1, 64, 16, 64, f32, f32).rows == 4
    assert kernel.prefill_plan(64, 8, 128, 16, 64, bf16, i8).rows == 8
    assert kernel.prefill_plan(64, 8, 128, 16, 64, f32, bf16).smem <= \
        kernel.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        kernel.prefill_plan(8, 1, 128, 16, 20000, f32, bf16)


# ---------------------------------------------------------------------------
# model: the port's chunk step vs the reference's
# ---------------------------------------------------------------------------

_MODELS = {}


def _models(arch):
    """(reference cfg, reference params, port cfg, port params on the CPU
    carrying the reference's weights)."""
    if arch not in _MODELS:
        rcfg = ref_configs.get_smoke_config(arch)
        cfg = port_configs.get_smoke_config(arch)
        ref_params = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
        params = transformer.params_from_numpy(
            jax.tree.map(np.asarray, ref_params), cfg, "cpu")
        _MODELS[arch] = (rcfg, ref_params, cfg, params)
    return _MODELS[arch]


#: (positions, lengths) of three chunk steps over 4 slots of 4 blocks of
#: 8: slot 3 idle, slot 1 stalled (lengths 0 with mapped blocks) in the
#: second step, rows of 1, chunks crossing block edges
CHUNK_STEPS = [([0, 0, 0, 0], [6, 3, 1, 0]),
               ([6, 3, 1, 0], [4, 0, 6, 0]),
               ([10, 3, 7, 0], [1, 2, 6, 0])]


@pytest.mark.parametrize("arch", ["gpt2-124m", "qwen3-1.7b"])
def test_prefill_step_paged_matches_reference(arch):
    rcfg, ref_params, cfg, params = _models(arch)
    B, max_len, bs, C = 4, 32, 8, 6
    rng = np.random.default_rng(3)
    tables = rng.permutation(np.arange(1, 1 + B * max_len // bs)).reshape(
        B, -1).astype(np.int32)
    tables[3] = 0
    ref_cache = ref_tf.init_paged_cache(rcfg, B, max_len, bs)
    cache = transformer.init_paged_cache(cfg, B, max_len, bs, "cpu")
    ref_step = jax.jit(lambda p, t, c, pos, bt, lens:
                       ref_tf.prefill_step_paged(p, rcfg, t, c, pos, bt, lens,
                                                 block_size=bs))
    for pos, lens in CHUNK_STEPS:
        pos, lens = np.asarray(pos, np.int32), np.asarray(lens, np.int32)
        tokens = rng.integers(0, cfg.vocab, (B, C)).astype(np.int32)
        want, ref_cache = ref_step(ref_params, tokens, ref_cache, pos,
                                   tables, lens)
        got, cache = transformer.prefill_step_paged(
            params, cfg, torch.from_numpy(tokens), cache,
            torch.from_numpy(pos), torch.from_numpy(tables),
            torch.from_numpy(lens), block_size=bs)
        assert got.shape == (B, C, cfg.vocab_padded)
        assert got.dtype == torch.float32
        for b in range(B):
            np.testing.assert_allclose(
                got.numpy()[b, :lens[b]], np.asarray(want)[b, :lens[b]],
                rtol=RTOL, atol=ATOL, err_msg=f"{arch} slot {b}")
        for key in ("k", "v"):
            pool = np.asarray(ref_cache["blocks"]["slot0"][key])
            np.testing.assert_allclose(cache[key].numpy()[:, 1:],
                                       pool[:, 1:], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch", ["gpt2-124m", "qwen3-1.7b"])
def test_last_rows_gives_exactly_those_rows(arch):
    """``last_rows`` gathers before the final norm and LM head: the same
    logits as the full step's rows at those indices, and the same pools."""
    _, _, cfg, params = _models(arch)
    B, max_len, bs = 3, 32, 8
    tables = torch.arange(1, 1 + B * 4, dtype=torch.int32).reshape(B, 4)
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (B, 8)).astype(np.int32))
    pos = torch.tensor([0, 5, 9], dtype=torch.int32)
    lens = torch.tensor([8, 1, 0], dtype=torch.int32)
    last = torch.clamp(lens - 1, min=0)
    caches = [transformer.init_paged_cache(cfg, B, max_len, bs, "cpu")
              for _ in range(2)]
    full, _ = transformer.prefill_step_paged(
        params, cfg, tokens, caches[0], pos, tables, lens, block_size=bs)
    rows, _ = transformer.prefill_step_paged(
        params, cfg, tokens, caches[1], pos, tables, lens, block_size=bs,
        last_rows=last)
    assert rows.shape == (B, 1, cfg.vocab_padded)
    assert torch.equal(rows[:, 0], full[torch.arange(B), last.long()])
    for key in ("k", "v"):
        assert torch.equal(caches[0][key], caches[1][key])


def test_prefill_step_refuses_a_block_size_the_pools_do_not_have():
    _, _, cfg, params = _models("gpt2-124m")
    cache = transformer.init_paged_cache(cfg, 1, 16, 8, "cpu")
    with pytest.raises(ValueError, match="block_size"):
        transformer.prefill_step_paged(
            params, cfg, torch.zeros((1, 2), dtype=torch.int32), cache,
            torch.zeros(1, dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), block_size=4)


# ---------------------------------------------------------------------------
# engine: the port's chunked engine vs the JAX engine, and inside the port
# ---------------------------------------------------------------------------


def _prompts(seed, lens, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _serve(engine_cls, request_cls, cfg, params, prompts, max_new=4,
           eos=None, hook=None, **kw):
    eng = engine_cls(cfg, params, **kw)
    if hook is not None:
        eng.add_step_hook(hook)
    for uid, p in enumerate(prompts):
        eng.submit(request_cls(uid=uid, prompt=p.copy(),
                               max_new_tokens=max_new,
                               eos_id=(eos or {}).get(uid, -1)))
    eng.run_until_drained()
    return eng


def _port(prompts, chunk=1, budget=None, arch="gpt2-124m", **kw):
    _, _, cfg, params = _models(arch)
    kw = dict(dict(max_batch=2, max_len=64, block_size=8), **kw)
    return _serve(ServeEngine, Request, cfg, params, prompts,
                  prefill_chunk=chunk, prefill_budget=budget, device="cpu",
                  **kw)


def _streams(eng):
    return {u: r.generated for u, r in eng.completed.items()}


@pytest.mark.parametrize("arch", ["gpt2-124m", "qwen3-1.7b"])
def test_chunked_engine_matches_the_reference_engine(arch):
    rcfg, ref_params, cfg, params = _models(arch)
    prompts = _prompts(0, (13, 3, 21, 6, 9, 2))
    kw = dict(max_batch=3, max_len=48, block_size=8, prefill_chunk=4,
              prefill_budget=6, max_new=5)
    ref = _serve(ref_engine.ServeEngine, ref_engine.Request, rcfg,
                 ref_params, prompts, **kw)
    port = _serve(ServeEngine, Request, cfg, params, prompts, device="cpu",
                  **kw)
    assert _streams(port) == _streams(ref)
    assert port.steps == ref.steps
    assert port.busy_slot_steps == ref.busy_slot_steps
    assert port.block_history == ref.block_history
    assert ({u: r.ttft_steps for u, r in port.completed.items()}
            == {u: r.ttft_steps for u, r in ref.completed.items()})
    assert set(port.stats()) == set(ref.stats())


def test_chunk_sweep_serves_the_token_by_token_streams():
    """Chunks 1, 3, 7 and the whole prompt: the same greedy streams,
    fused steps non-increasing in the chunk, strictly fewer than
    token-by-token for every chunk > 1."""
    prompts = _prompts(12, (13, 5, 29, 8))
    runs = {c: _port(prompts, chunk=c, max_new=5) for c in (1, 3, 7, 32)}
    steps = [runs[c].steps for c in (1, 3, 7, 32)]
    for c, eng in runs.items():
        assert _streams(eng) == _streams(runs[1]), c
        if c > 1:
            assert eng.steps < runs[1].steps, (c, steps)
    assert steps == sorted(steps, reverse=True), steps


def test_budget_one_crawls_but_serves_the_same_streams():
    prompts = _prompts(22, (11, 6, 17))
    base, crawl = _port(prompts), _port(prompts, chunk=8, budget=1)
    assert _streams(crawl) == _streams(base)
    assert crawl.steps >= base.steps


def test_prefill_budget_never_starves_decode():
    """While a 40-token prompt prefills under an 8-token budget, the
    decoding request advances by exactly one token every step."""
    short, long = _prompts(21, (4, 40))
    trace = []

    def hook(engine, busy):
        live = engine._live
        trace.append({r.uid: int(live["positions"][b])
                      for b, r in enumerate(live["slot_req"])
                      if r is not None})
        return False

    def run(chunk, budget=None, hook=None):
        eng = ServeEngine(*_models("gpt2-124m")[2:], max_batch=2,
                          max_len=64, block_size=8, prefill_chunk=chunk,
                          prefill_budget=budget, device="cpu")
        if hook is not None:
            eng.add_step_hook(hook)
        eng.submit(Request(uid=0, prompt=short.copy(), max_new_tokens=10))
        eng.submit(Request(uid=1, prompt=long.copy(), max_new_tokens=4))
        eng.run_until_drained()
        return eng

    chunked, base = run(8, budget=8, hook=hook), run(1)
    assert _streams(chunked) == _streams(base)
    overlap = 0
    for prev, cur in zip(trace, trace[1:]):
        if not all(u in prev and u in cur for u in (0, 1)):
            continue
        if prev[0] >= len(short) and 0 < prev[1] < len(long):
            assert cur[0] == prev[0] + 1, (prev, cur)
            overlap += 1
        if 0 < prev[1] < len(long):
            assert cur[1] - prev[1] <= 8, (prev, cur)
    assert overlap >= 3, trace
    free = run(8)
    assert _streams(free) == _streams(base)
    assert free.completed[1].ttft_steps <= chunked.completed[1].ttft_steps


def test_preempt_mid_prefill_replays_the_same_stream():
    """Evicting a request in the middle of its chunked prefill (its
    ``tokens`` row is (C,) wide) replays prompt + generated on
    re-admission and serves the same stream."""
    prompts = _prompts(23, (5, 33))
    fired = []

    def hook(engine, busy):
        live = engine._live
        assert live["tokens"].shape == (2, 8)
        for b, r in enumerate(live["slot_req"]):
            if (not fired and r is not None and r.uid == 1
                    and 0 < live["positions"][b] < 33):
                fired.append(engine.preempt(uid=1))
        return False

    base = _port(prompts, max_new=5)
    faulted = _port(prompts, chunk=8, budget=8, max_new=5, hook=hook)
    assert fired == [1] and faulted.preemptions == 1
    assert _streams(faulted) == _streams(base)


def test_chunked_engine_respects_eos():
    prompts = _prompts(14, (9, 17))
    eos0 = _port(prompts[:1], max_new=1, max_batch=1).completed[0] \
        .generated[0]
    base = _port(prompts, max_new=6, eos={0: eos0})
    chunked = _port(prompts, chunk=8, max_new=6, eos={0: eos0})
    assert chunked.completed[0].generated == [eos0]
    assert _streams(chunked) == _streams(base)


def test_ttft_steps_fall_on_a_bimodal_mix():
    """Short prompts behind long ones: the step-clock TTFT drops under
    chunked prefill, with the same streams."""
    prompts = _prompts(13, (48, 4, 48, 4, 4, 48))
    base = _port(prompts, max_new=4)
    chunked = _port(prompts, chunk=16, budget=16, max_new=4)
    assert _streams(chunked) == _streams(base)
    bs_, cs_ = base.stats(), chunked.stats()
    assert cs_["ttft_p95_steps"] < bs_["ttft_p95_steps"]
    assert cs_["ttft_p50_steps"] < bs_["ttft_p50_steps"]
    assert (cs_["prefill_chunk"], bs_["prefill_chunk"]) == (16, 1)


def test_ttft_steps_are_the_same_in_two_runs():
    """The step-clock TTFT is a function of the trace alone."""
    prompts = _prompts(24, (30, 4, 30, 4))
    a, b = (_port(prompts, chunk=8, budget=8, max_new=3) for _ in range(2))
    ttft = [[e.completed[u].ttft_steps for u in range(4)] for e in (a, b)]
    assert ttft[0] == ttft[1] and all(t >= 1 for t in ttft[0])
    assert a.stats()["ttft_p95_steps"] == b.stats()["ttft_p95_steps"]


def test_chunked_engine_rejects_oversized_requests_at_submit():
    _, _, cfg, params = _models("gpt2-124m")
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32,
                      prefill_chunk=8, device="cpu")
    with pytest.raises(port_engine.RequestTooLong):
        eng.submit(Request(uid=0, prompt=np.arange(20, dtype=np.int32),
                           max_new_tokens=20))
    assert not eng.queue


def test_bucket_width_is_the_reference_rule():
    for m in range(0, 40):
        for cap in (1, 3, 8, 32):
            assert port_engine._bucket_width(m, cap) == \
                ref_engine._bucket_width(m, cap), (m, cap)


# ---------------------------------------------------------------------------
# validation, warm-up and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(prefill_chunk=0), "prefill_chunk must be >= 1"),
    (dict(prefill_budget=0), "prefill_budget must be >= 1"),
    pytest.param(dict(prefill_chunk=4, spec_k=2, draft=True),
                 "combine it with prefill_chunk=1", id=r"kw2-1\.13"),
])
def test_chunked_options_are_validated_as_in_the_reference(kw, match):
    """The reference's messages; speculation (1.13) with a chunk wider
    than one token is refused as the reference refuses it."""
    _, _, cfg, params = _models("gpt2-124m")
    kw = dict(kw)
    if kw.pop("draft", False):
        kw.update(draft_cfg=cfg, draft_params=params)
    with pytest.raises(ValueError, match=match):
        ServeEngine(cfg, params, device="cpu", **kw)


@pytest.mark.parametrize("chunk,widths", [(6, [2, 4, 6]), (8, [2, 4, 8]),
                                          (1, [])])
def test_warmup_runs_every_bucket_width(monkeypatch, chunk, widths):
    _, _, cfg, params = _models("gpt2-124m")
    seen = []
    real = transformer.prefill_step_paged

    def spy(params, cfg, tokens, *args, **kw):
        seen.append(tokens.shape[1])
        return real(params, cfg, tokens, *args, **kw)

    monkeypatch.setattr(transformer, "prefill_step_paged", spy)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32, block_size=8,
                      prefill_chunk=chunk, device="cpu")
    eng.warmup()
    assert seen == widths
    assert eng.steps == 0 and eng.busy_slot_steps == 0


def test_cli_serves_chunked_prefill(tmp_path, capsys):
    out = tmp_path / "report.json"
    argv = ["--device", "cpu", "--requests", "6", "--max-new", "4",
            "--prompt-hi", "30", "--max-len", "64"]
    assert serve.main(argv + ["--prefill-chunk", "8", "--prefill-budget",
                              "16", "--out", str(out)]) == 0
    printed = capsys.readouterr().out
    assert "[prefill chunk 8, budget 16]" in printed
    report = json.loads(out.read_text())
    assert (report["prefill_chunk"], report["prefill_budget"]) == (8, 16)
    assert report["stats"]["prefill_chunk"] == 8
    assert len(report["requests"]) == 6
    base = tmp_path / "base.json"
    serve.main(argv + ["--out", str(base)])
    assert "[prefill chunk" not in capsys.readouterr().out
    tokens = [r["tokens"] for r in report["requests"]]
    assert tokens == [r["tokens"] for r in
                      json.loads(base.read_text())["requests"]]
    assert report["stats"]["fused_steps"] < \
        json.loads(base.read_text())["stats"]["fused_steps"]
