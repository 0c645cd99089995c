"""Prefix sharing (copy-on-write) and quantized paging in the port's
serving engine, mirroring ``tests/test_serve_sharing.py`` for the dense
archs the port serves (gpt2-124m and qwen3-1.7b smoke), on the reference's
weights carried across by ``params_from_numpy``.

Sharing changes placement only: streams equal to the unshared engine's, in
f32 and int8, token by token and chunked, with strictly fewer physical
blocks; identical prompts copy on write at the first generated token;
preempting a sharing slot decrefs and never frees; a stale partial tail
after a preemption never aliases.  Quantization changes precision by a
bounded amount: first tokens equal f32's and bf16 tracks f32 on the
reference's trace.  The port's f32 sharing streams and block accounting
equal the JAX engine's.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
ARCHS = ("gpt2-124m", "qwen3-1.7b")
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        rcfg = ref_configs.get_smoke_config(arch)
        cfg = port_configs.get_smoke_config(arch)
        rp = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
        pp = transformer.params_from_numpy(jax.tree.map(np.asarray, rp), cfg,
                                           "cpu")
        _MODELS[arch] = (rcfg, rp, cfg, pp)
    return _MODELS[arch]


def _bimodal_prompts(vocab, rng, n=4, prefix_lens=(17, 9), tail_hi=2):
    """The reference test's traffic: two long system prompts, short unique
    tails."""
    groups = [rng.integers(0, vocab, size=p).astype(np.int32)
              for p in prefix_lens]
    prompts = []
    for i in range(n):
        tail = rng.integers(0, vocab, size=int(rng.integers(1, tail_hi + 1)))
        prompts.append(np.concatenate([groups[i % len(groups)],
                                       tail.astype(np.int32)]))
    return prompts


def _serve(arch, prompts, *, share=False, kv_dtype="f32", max_new=4,
           max_batch=4, max_len=64, bs=8, hook=None, reference=False, **kw):
    rcfg, rp, cfg, pp = _model(arch)
    if reference:
        eng = ref_engine.ServeEngine(rcfg, rp, max_batch=max_batch,
                                     max_len=max_len, block_size=bs,
                                     share_prefixes=share, kv_dtype=kv_dtype,
                                     **kw)
        Req = ref_engine.Request
    else:
        eng = ServeEngine(cfg, pp, max_batch=max_batch, max_len=max_len,
                          block_size=bs, share_prefixes=share,
                          kv_dtype=kv_dtype, device="cpu", **kw)
        Req = Request
    if hook is not None:
        eng.add_step_hook(hook)
    max_new = max_new if isinstance(max_new, dict) else {
        uid: max_new for uid in range(len(prompts))}
    for uid, p in enumerate(prompts):
        eng.submit(Req(uid=uid, prompt=p.copy(), max_new_tokens=max_new[uid]))
    eng.run_until_drained()
    return eng


def _streams(eng, n):
    return [eng.completed[u].generated for u in range(n)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_sharing_streams_identical_fewer_blocks(arch, kv_dtype, chunk):
    """Sharing on against sharing off on bimodal shared-prefix traffic:
    equal streams, equal logical blocks, strictly fewer physical blocks,
    dedup ratio > 1; the unshared engine never shares or forks."""
    _, _, cfg, _ = _model(arch)
    prompts = _bimodal_prompts(cfg.vocab, np.random.default_rng(31))
    kw = dict(kv_dtype=kv_dtype, prefill_chunk=chunk)
    base = _serve(arch, prompts, share=False, **kw)
    shared = _serve(arch, prompts, share=True, **kw)
    assert _streams(shared, 4) == _streams(base, 4), (arch, kv_dtype, chunk)
    sb, ss = base.stats(), shared.stats()
    assert ss["physical_blocks"] < sb["physical_blocks"]
    assert ss["logical_blocks"] == sb["logical_blocks"]
    assert ss["shared_block_hits"] > 0 and ss["block_dedup_ratio"] > 1.0
    assert sb["shared_block_hits"] == 0 and sb["cow_copies"] == 0
    assert sb["block_dedup_ratio"] == 1.0


@pytest.mark.parametrize("arch", ARCHS)
def test_f32_sharing_equals_the_jax_engine(arch):
    """The port's f32 sharing engine against the JAX engine on the same
    traffic: the same streams, blocks per request and dedup counters."""
    _, _, cfg, _ = _model(arch)
    prompts = _bimodal_prompts(cfg.vocab, np.random.default_rng(31))
    port = _serve(arch, prompts, share=True)
    ref = _serve(arch, prompts, share=True, reference=True)
    assert _streams(port, 4) == _streams(ref, 4)
    assert port.block_history == ref.block_history
    for key in ("logical_blocks", "physical_blocks", "shared_block_hits",
                "cow_copies", "block_dedup_ratio", "kv_bytes_served",
                "kv_bytes_stored", "fused_steps"):
        assert port.stats()[key] == ref.stats()[key], key


@pytest.mark.parametrize("chunk", [1, 4])
def test_identical_prompts_cow_at_first_generated_token(chunk):
    """Two identical prompts share every prompt span; the first generated
    token lands in the ragged shared block and forks it, and the streams
    equal an unshared run."""
    _, _, cfg, _ = _model("gpt2-124m")
    prompt = np.random.default_rng(32).integers(
        0, cfg.vocab, size=13).astype(np.int32)
    prompts = [prompt, prompt.copy()]
    base = _serve("gpt2-124m", prompts, max_new=6, prefill_chunk=chunk)
    shared = _serve("gpt2-124m", prompts, share=True, max_new=6,
                    prefill_chunk=chunk)
    assert _streams(shared, 2) == _streams(base, 2)
    s = shared.stats()
    assert s["shared_block_hits"] == 2
    assert s["cow_copies"] >= 1
    assert s["physical_blocks"] < base.stats()["physical_blocks"]


def test_dedup_accounting_flows_to_stats():
    """stats() carries the dedup counters, and the byte ratio equals the
    block ratio; int8 blocks are sized with their scales."""
    _, _, cfg, _ = _model("gpt2-124m")
    prompts = _bimodal_prompts(cfg.vocab, np.random.default_rng(33))
    for kv_dtype in ("f32", "int8"):
        s = _serve("gpt2-124m", prompts, share=True,
                   kv_dtype=kv_dtype).stats()
        assert s["share_prefixes"] is True and s["kv_dtype"] == kv_dtype
        assert s["kv_bytes_served"] > s["kv_bytes_stored"] > 0
        block = transformer.paged_block_bytes(cfg, 8, kv_dtype)
        assert s["kv_bytes_stored"] == s["physical_blocks"] * block
        assert s["block_dedup_ratio"] == pytest.approx(
            s["kv_bytes_served"] / s["kv_bytes_stored"])
        assert s["block_dedup_ratio"] == pytest.approx(
            s["logical_blocks"] / s["physical_blocks"])


def test_preempt_shared_slot_leaves_survivor_bit_identical():
    """Preempting one of two slots that share prefix blocks decrefs them
    (the survivor keeps reading them), and the preempted request replays
    its stream."""
    _, _, cfg, _ = _model("gpt2-124m")
    prompt = np.random.default_rng(34).integers(
        0, cfg.vocab, size=12).astype(np.int32)
    prompts = [prompt, prompt.copy()]
    base = _serve("gpt2-124m", prompts, share=True, max_new=6)
    fired = []

    def hook(engine, busy):
        for r in engine._live["slot_req"]:
            if (not fired and r is not None and r.uid == 1
                    and len(r.generated) >= 2):
                fired.append(engine.preempt(uid=1))
        return False

    faulted = _serve("gpt2-124m", prompts, share=True, max_new=6, hook=hook)
    assert faulted.preemptions == 1 and fired == [1]
    assert _streams(faulted, 2) == _streams(base, 2)
    assert (faulted.stats()["shared_block_hits"]
            >= base.stats()["shared_block_hits"])
    assert faulted.stats()["block_dedup_ratio"] > 1.0


def test_stale_partial_tail_after_preempt_serves_clean_streams():
    """Request 0 registers a 3-token ragged tail, request 1 joins with a
    1-token prefix of it, and request 0 is preempted on the step request 1
    writes its first generated token in place; request 0's replay must not
    alias the diverged block.  Streams equal the unshared baseline, with no
    copy-on-write."""
    _, _, cfg, _ = _model("gpt2-124m")
    rng = np.random.default_rng(37)
    chain = rng.integers(0, cfg.vocab, size=8).astype(np.int32)
    tail = rng.integers(0, cfg.vocab, size=3).astype(np.int32)
    prompts = [np.concatenate([chain, tail]),
               np.concatenate([chain, tail[:1]])]
    max_new = {0: 4, 1: 16}
    fired = []

    def hook(engine, busy):
        live = engine._live
        if live is None or fired:
            return False
        for b, r in enumerate(live["slot_req"]):
            if r is not None and r.uid == 1 and live["positions"][b] == 9:
                fired.append(engine.preempt(uid=0))
        return False

    kw = dict(max_new=max_new, max_batch=2, max_len=32)
    base = _serve("gpt2-124m", prompts, **kw)
    faulted = _serve("gpt2-124m", prompts, share=True, hook=hook, **kw)
    assert fired == [0] and faulted.preemptions == 1
    assert _streams(faulted, 2) == _streams(base, 2)
    s = faulted.stats()
    assert s["shared_block_hits"] > 0
    assert s["cow_copies"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_engine_serves_and_reports_kv_dtype(arch):
    """Every request drains in full under each kv_dtype, stats() names the
    dtype, every first token equals f32's, and bf16 tracks f32 token for
    token on the reference's trace."""
    _, _, cfg, _ = _model(arch)
    rng = np.random.default_rng(35)
    prompts = [rng.integers(0, cfg.vocab, size=int(n)).astype(np.int32)
               for n in (11, 5, 9)]
    runs = {kd: _serve(arch, prompts, kv_dtype=kd, max_new=5, max_batch=2)
            for kd in ("f32", "bf16", "int8")}
    f32 = _streams(runs["f32"], 3)
    for kd, eng in runs.items():
        assert eng.stats()["kv_dtype"] == kd
        for uid, got in enumerate(_streams(eng, 3)):
            assert len(got) == 5, (kd, uid)
            assert got[0] == f32[uid][0], (kd, uid)
    assert _streams(runs["bf16"], 3) == f32


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_sharing_compose(arch):
    """int8 pools with prefix sharing serve the streams of the int8
    unshared engine, and on this traffic those of the f32 unshared one."""
    _, _, cfg, _ = _model(arch)
    prompts = _bimodal_prompts(cfg.vocab, np.random.default_rng(36))
    base = _serve(arch, prompts)
    int8 = _serve(arch, prompts, kv_dtype="int8")
    both = _serve(arch, prompts, kv_dtype="int8", share=True)
    assert _streams(both, 4) == _streams(int8, 4) == _streams(base, 4)
    assert both.stats()["block_dedup_ratio"] > 1.0
    assert both.stats()["kv_dtype"] == "int8"


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_quantized_chunked_streams_equal_token_by_token(arch, kv_dtype):
    """Chunk rows and decode rows are stored by one code path (the commit
    kernel's formula), so chunked prefill serves the token-by-token
    streams under bf16 and int8 pools too, with and without sharing."""
    _, _, cfg, _ = _model(arch)
    prompts = _bimodal_prompts(cfg.vocab, np.random.default_rng(38))
    token = _serve(arch, prompts, kv_dtype=kv_dtype)
    for share in (False, True):
        chunked = _serve(arch, prompts, kv_dtype=kv_dtype, share=share,
                         prefill_chunk=8, prefill_budget=12)
        assert _streams(chunked, 4) == _streams(token, 4), share
