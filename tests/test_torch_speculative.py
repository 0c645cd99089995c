"""The port's speculative decoding against ``repro.serve.speculative``,
mirroring ``tests/test_speculative.py``.

Every case serves the reference test's traffic on the reference's weights
(``params_from_numpy``) through the port's engine and the JAX engine, and
holds the port to both its own non-speculative engine and the JAX
speculative engine: streams, fused (target) steps, draft steps, drafted,
accepted and rejected counts, and block histories.  Speculation changes
how many target steps a stream costs, never its tokens: self-speculation
accepts every draft, and an adversarial draft (gpt2 drawn with init seed
123) is rejected, rewound, and on the stateful archs restored and
replayed, with the block pool's invariants clean after every step.  The
reference's scenario-matrix cases wait for ROADMAP 1.14 and its ledger
fork for 1.15.
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

SERVE_ARCHS = (
    "gpt2-124m", "qwen3-1.7b", "mamba2-370m", "deepseek-v2-lite-16b",
    "deepseek-moe-16b", "jamba-1.5-large-398b",
)
#: what the port must count as the JAX engine does
COUNTS = ("fused_steps", "target_steps", "draft_steps", "drafted_tokens",
          "accepted_tokens", "rejected_tokens", "busy_slot_steps",
          "logical_blocks", "physical_blocks", "shared_block_hits",
          "cow_copies")
_MODELS = {}


def _model(arch, init_seed=0):
    key = (arch, init_seed)
    if key not in _MODELS:
        rcfg = ref_configs.get_smoke_config(arch)
        cfg = port_configs.get_smoke_config(arch)
        rp = ref_steps.init_model(jax.random.PRNGKey(init_seed), rcfg)
        params = transformer.params_from_numpy(jax.tree.map(np.asarray, rp),
                                               cfg, "cpu")
        _MODELS[key] = (rcfg, rp, cfg, params)
    return _MODELS[key]


def _traffic(vocab, request_cls, n=4, seed=17, max_new=8):
    rng = np.random.default_rng(seed)
    return [request_cls(uid=i, prompt=rng.integers(
        1, vocab, size=int(rng.integers(3, 9))).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


def _invariant_hook(record):
    """Asserts the block pool's invariants at every step of a drain."""
    def hook(eng, busy):
        if eng._live is not None:
            eng._live["pool"].check_invariants()
            record.append(True)
        return False
    return hook


def _serve(arch, *, jax_engine=False, spec_k=0, draft=None, hook=None,
           n=4, max_new=8, **kw):
    """Serve the traffic; ``draft`` is ``(arch, init_seed)``."""
    rcfg, rp, cfg, params = _model(arch)
    if spec_k:
        drcfg, drp, dcfg, dparams = _model(*draft)
        kw.update(spec_k=spec_k,
                  **(dict(draft_cfg=drcfg, draft_params=drp) if jax_engine
                     else dict(draft_cfg=dcfg, draft_params=dparams)))
    if jax_engine:
        eng = ref_engine.ServeEngine(rcfg, rp, max_batch=2, max_len=64,
                                     block_size=8, **kw)
        reqs = _traffic(rcfg.vocab, ref_engine.Request, n, max_new=max_new)
    else:
        eng = ServeEngine(cfg, params, max_batch=2, max_len=64, block_size=8,
                          device="cpu", **kw)
        reqs = _traffic(cfg.vocab, Request, n, max_new=max_new)
    if hook is not None:
        eng.add_step_hook(hook)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return eng


def _streams(eng):
    return {uid: r.generated for uid, r in eng.completed.items()}


def _held(arch, **kw):
    """The port's speculative engine, after holding it to the JAX one."""
    port = _serve(arch, **kw)
    ref = _serve(arch, jax_engine=True, **kw)
    assert _streams(port) == _streams(ref)
    st, rst = port.stats(), ref.stats()
    for key in COUNTS:
        assert st[key] == rst[key], key
    assert st["acceptance_rate"] == pytest.approx(rst["acceptance_rate"])
    assert port.block_history == ref.block_history
    return port


# -- self-speculation ----------------------------------------------------------


def test_self_spec_accepts_everything_and_saves_steps():
    base = _serve("gpt2-124m")
    spec = _held("gpt2-124m", spec_k=4, draft=("gpt2-124m", 0))
    assert _streams(spec) == _streams(base)
    s = spec.stats()
    assert s["acceptance_rate"] == 1.0
    assert s["rejected_tokens"] == 0
    assert s["accepted_tokens"] == s["drafted_tokens"] > 0
    assert s["spec_k"] == 4 and s["draft_steps"] > 0
    assert s["target_steps"] < base.stats()["fused_steps"]
    assert s["target_steps"] == s["fused_steps"]


def test_self_spec_equal_at_temperature():
    kw = dict(temperature=0.8, top_k=10, sample_seed=42)
    base = _serve("gpt2-124m", **kw)
    spec = _held("gpt2-124m", spec_k=4, draft=("gpt2-124m", 0), **kw)
    assert _streams(spec) == _streams(base)
    assert spec.stats()["acceptance_rate"] == 1.0


# -- adversarial draft ---------------------------------------------------------


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_adversarial_draft_streams_identical_every_arch(arch):
    """Rejections rewind positions, decref tail blocks and, on mamba2 and
    jamba, restore and replay the recurrent state; MoE and MLA verify
    each window row as its own routing group.  Streams stay the
    non-speculative engine's and the JAX engine's."""
    base = _serve(arch, max_new=6)
    checks = []
    adv = _held(arch, spec_k=3, draft=("gpt2-124m", 123),
                hook=_invariant_hook(checks), max_new=6)
    assert _streams(adv) == _streams(base)
    s = adv.stats()
    assert s["drafted_tokens"] > 0 and s["rejected_tokens"] > 0
    assert s["acceptance_rate"] < 1.0
    assert checks and all(checks)
    if transformer.has_state(adv.cfg):
        # each rejected window spent a replay call
        assert s["fused_steps"] > base.stats()["fused_steps"]


def test_rejection_rewind_frees_tail_blocks():
    checks = []
    adv = _serve("gpt2-124m", spec_k=4, draft=("gpt2-124m", 123),
                 hook=_invariant_hook(checks))
    assert adv.stats()["rejected_tokens"] > 0
    assert checks and all(checks)
    assert adv._live is None and len(adv.completed) == 4
    # every block a request held went back: the decref'd tails too
    assert adv.stats()["physical_blocks"] == _held(
        "gpt2-124m", spec_k=4, draft=("gpt2-124m", 123)).stats()[
            "physical_blocks"]


@pytest.mark.parametrize("kv_dtype,share", [("int8", True), ("bf16", False)])
def test_spec_composes_with_quantized_sharing(kv_dtype, share):
    kw = dict(kv_dtype=kv_dtype, share_prefixes=share)
    base = _serve("gpt2-124m", **kw)
    checks = []
    spec = _serve("gpt2-124m", spec_k=4, draft=("gpt2-124m", 0),
                  hook=_invariant_hook(checks), **kw)
    assert _streams(spec) == _streams(base)
    s = spec.stats()
    assert s["drafted_tokens"] > 0
    assert checks and all(checks)
    assert s["share_prefixes"] is share
    if kv_dtype == "int8":
        # the int8 pools attend the quantized new row where the JAX cell
        # merges it unquantized (ROADMAP section 3): the JAX engine is
        # held to the first token of each stream and the pool's counts
        ref = _serve("gpt2-124m", jax_engine=True, spec_k=4,
                     draft=("gpt2-124m", 0), **kw)
        assert {u: g[:1] for u, g in _streams(spec).items()} == \
            {u: g[:1] for u, g in _streams(ref).items()}
    else:
        _held("gpt2-124m", spec_k=4, draft=("gpt2-124m", 0), **kw)


# -- validation ----------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(spec_k=4), "requires a draft"),
    (dict(spec_k=-1), "spec_k must be >= 0"),
    (dict(scheduler="wave", spec_k=4, draft=True), "continuous"),
    (dict(prefill_chunk=4, spec_k=4, draft=True), "prefill_chunk=1"),
    (dict(draft=True), "spec_k >= 1"),
    (dict(spec_adaptive=True), "spec_adaptive"),
])
def test_spec_validation_messages_are_the_reference_ones(kw, match):
    rcfg, rp, cfg, params = _model("gpt2-124m")
    kw = dict(kw)
    draft = kw.pop("draft", False)
    with pytest.raises(ValueError, match=match) as want:
        ref_engine.ServeEngine(rcfg, rp, max_batch=2, max_len=64, **kw,
                               **(dict(draft_cfg=rcfg, draft_params=rp)
                                  if draft else {}))
    with pytest.raises(ValueError) as got:
        ServeEngine(cfg, params, max_batch=2, max_len=64, device="cpu", **kw,
                    **(dict(draft_cfg=cfg, draft_params=params)
                       if draft else {}))
    assert str(got.value) == str(want.value)


def test_stateful_draft_rejected():
    _, _, cfg, params = _model("gpt2-124m")
    _, _, scfg, sparams = _model("mamba2-370m")
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(cfg, params, max_batch=2, max_len=64, spec_k=4,
                    draft_cfg=scfg, draft_params=sparams, device="cpu")


# -- adaptive draft width ------------------------------------------------------


def test_adaptive_width_streams_identical_drafts_fewer():
    base = _serve("gpt2-124m")
    fixed = _serve("gpt2-124m", spec_k=3, draft=("gpt2-124m", 123))
    adapt = _held("gpt2-124m", spec_k=3, draft=("gpt2-124m", 123),
                  spec_adaptive=True)
    assert _streams(adapt) == _streams(base) == _streams(fixed)
    sf, sa = fixed.stats(), adapt.stats()
    assert sf["acceptance_rate"] < 1.0
    assert 0 < sa["drafted_tokens"] < sf["drafted_tokens"]
    assert sa["spec_adaptive"] is True and sf["spec_adaptive"] is False


def test_adaptive_width_keeps_full_width_on_self_draft():
    fixed = _serve("gpt2-124m", spec_k=3, draft=("gpt2-124m", 0))
    adapt = _serve("gpt2-124m", spec_k=3, draft=("gpt2-124m", 0),
                   spec_adaptive=True)
    assert _streams(adapt) == _streams(fixed)
    assert adapt.stats()["acceptance_rate"] == 1.0
    assert adapt.stats()["drafted_tokens"] == fixed.stats()["drafted_tokens"]


def test_adaptive_ema_clamps_and_recovers():
    eng = _serve("gpt2-124m", spec_k=4, draft=("gpt2-124m", 0),
                 spec_adaptive=True, n=1, max_new=2)
    spec = eng._spec
    uid = 999
    assert spec._draft_width(uid) == 4
    for _ in range(8):
        spec._note_accept(uid, 0, 4)
    assert spec._accept_ema[uid] < 0.1
    assert spec._draft_width(uid) == 0
    for _ in range(32):
        if spec._draft_width(uid) > 0:
            break
    assert spec._draft_width(uid) >= 1
    spec._accept_ema[uid] = 5.0
    assert spec._draft_width(uid) == 4


# -- preemption, warm-up, the state snapshot -----------------------------------


@pytest.mark.parametrize("arch", ["gpt2-124m", "mamba2-370m"])
def test_preempt_mid_speculation_replays_the_same_stream(arch):
    """A step hook preempts uid 1 once it has generated 3 tokens, in the
    middle of a speculative drain; the request is re-admitted, replays
    its prompt and tokens, and the streams are the unpreempted ones, as
    in the JAX engine under the same hook."""
    def hook_for(fired):
        def hook(eng, busy):
            for r in eng._live["slot_req"]:
                if (not fired and r is not None and r.uid == 1
                        and len(r.generated) >= 3):
                    fired.append(eng.preempt(uid=1))
            return False
        return hook

    base = _serve(arch)
    fired, rfired = [], []
    kw = dict(spec_k=3, draft=("gpt2-124m", 123))
    eng = _serve(arch, hook=hook_for(fired), **kw)
    ref = _serve(arch, jax_engine=True, hook=hook_for(rfired), **kw)
    assert fired == rfired == [1] and eng.preemptions == 1
    assert _streams(eng) == _streams(base) == _streams(ref)
    assert eng.steps == ref.steps
    assert eng.draft_steps == ref.draft_steps


def test_warmup_runs_the_verification_and_draft_widths(monkeypatch):
    _, _, cfg, params = _model("gpt2-124m")
    seen = []
    real = transformer.prefill_step_paged

    def spy(params, cfg, tokens, *args, **kw):
        seen.append((cfg.name, tokens.shape[1], "last_rows" in kw))
        return real(params, cfg, tokens, *args, **kw)

    monkeypatch.setattr(transformer, "prefill_step_paged", spy)
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32, block_size=8,
                      spec_k=3, draft_cfg=cfg, draft_params=params,
                      device="cpu")
    eng.warmup()
    assert seen == [(cfg.name, 4, False), (cfg.name, 1, False)]
    assert eng.steps == 0 and eng.draft_steps == 0


def test_slot_state_is_a_copy_and_restore_is_masked():
    """The port's steps update the states in place, so a snapshot that
    held the leaves themselves would follow every later step; it must be
    a copy, and a restore must leave the slots it is not asked to touch
    bit for bit."""
    _, _, cfg, params = _model("mamba2-370m")
    B = 3
    cache = transformer.init_paged_cache(cfg, B, 32, 8, "cpu")
    gen = torch.Generator().manual_seed(0)
    for key in ("ssm_state", "conv_state"):
        cache[key].copy_(torch.randn(cache[key].shape, generator=gen))
    snap = transformer.slot_state(cache)
    assert set(snap) == {"ssm_state", "conv_state"}
    before = {k: v.clone() for k, v in cache.items()}
    for key in snap:
        assert snap[key].data_ptr() != cache[key].data_ptr()
    transformer.prefill_step_paged(
        params, cfg, torch.ones((B, 2), dtype=torch.int32), cache,
        torch.zeros(B, dtype=torch.int32),
        torch.zeros((B, 4), dtype=torch.int32),
        torch.tensor([2, 2, 1], dtype=torch.int32), block_size=8)
    moved = {k: v.clone() for k, v in cache.items()}
    for key in snap:
        torch.testing.assert_close(snap[key], before[key], rtol=0, atol=0)
        assert not torch.equal(moved[key], before[key])
    mask = np.array([True, False, True])
    assert transformer.restore_slot_state(cache, snap, mask) is cache
    for key in snap:
        torch.testing.assert_close(cache[key][:, mask],
                                   before[key][:, mask], rtol=0, atol=0)
        torch.testing.assert_close(cache[key][:, ~mask],
                                   moved[key][:, ~mask], rtol=0, atol=0)
    # an attention-only cache has no state to snapshot
    gcfg = _model("gpt2-124m")[2]
    assert transformer.slot_state(
        transformer.init_paged_cache(gcfg, B, 32, 8, "cpu")) == {}
