"""The port's sampler against ``repro.serve.sampling``, mirroring
``tests/test_sampling.py``.

On the same ``(B, W, V)`` logits the port's :class:`SlotSampler` picks the
reference's tokens: with windows, offsets, top-k and temperatures whose
reciprocal is not exact in fp32.  Sampled engine streams equal the JAX
engine's on the reference's weights for every serve arch, are
reproducible, and move with the seed; at temperature 0 the engine is the
greedy one.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.serve import sampling as ref_sampling  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.sampling import SlotSampler  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

SERVE_ARCHS = (
    "gpt2-124m", "qwen3-1.7b", "mamba2-370m", "deepseek-v2-lite-16b",
    "deepseek-moe-16b", "jamba-1.5-large-398b",
)
_MODELS = {}


def _model(arch):
    if arch not in _MODELS:
        rcfg = ref_configs.get_smoke_config(arch)
        cfg = port_configs.get_smoke_config(arch)
        rp = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
        params = transformer.params_from_numpy(jax.tree.map(np.asarray, rp),
                                               cfg, "cpu")
        _MODELS[arch] = (rcfg, rp, cfg, params)
    return _MODELS[arch]


def _traffic(vocab, request_cls, n=4, seed=11, max_new=6):
    """The reference test's traffic."""
    rng = np.random.default_rng(seed)
    return [request_cls(uid=i, prompt=rng.integers(
        1, vocab, size=int(rng.integers(3, 9))).astype(np.int32),
        max_new_tokens=max_new) for i in range(n)]


def _streams(arch, *, jax_engine=False, max_batch=2, **kw):
    rcfg, rp, cfg, params = _model(arch)
    if jax_engine:
        eng = ref_engine.ServeEngine(rcfg, rp, max_batch=max_batch,
                                     max_len=64, block_size=8, **kw)
        reqs = _traffic(rcfg.vocab, ref_engine.Request)
    else:
        eng = ServeEngine(cfg, params, max_batch=max_batch, max_len=64,
                          block_size=8, device="cpu", **kw)
        reqs = _traffic(cfg.vocab, Request)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {uid: r.generated for uid, r in eng.completed.items()}


def _fake_reqs(uids, gen_lens):
    return [types.SimpleNamespace(uid=u, generated=[0] * g)
            for u, g in zip(uids, gen_lens)]


# -- the sampler itself --------------------------------------------------------


@pytest.mark.parametrize("temperature,top_k", [
    (0.6, 0), (0.7, 5), (1.3, 0), (0.8, 40), (0.9, 1)])
@pytest.mark.parametrize("width,offset", [(1, 0), (4, 3)])
def test_sampler_picks_the_reference_tokens(temperature, top_k, width,
                                            offset):
    """Same logits, same reqs: the reference's tokens, row for row.  The
    vocab is padded past ``vocab`` as the engines' logits are; uids and
    generation indices include uint32 edge values."""
    rng = np.random.default_rng(int(temperature * 10) + top_k + width)
    vocab, padded, B = 1000, 1024, 6
    rows = (2.0 * rng.standard_normal((B, width, padded))).astype(np.float32)
    reqs = _fake_reqs([0, 1, 2**31 - 1, 2**32 - 1, 7, 2**32 + 5],
                      [0, 5, 1, 3, 30, 2])
    reqs[4] = None  # an idle slot
    ref = ref_sampling.SlotSampler(vocab, temperature=temperature,
                                   top_k=top_k, seed=17)
    port = SlotSampler(vocab, temperature=temperature, top_k=top_k, seed=17)
    want = ref.select(jnp.asarray(rows), reqs, offset=offset)
    got = port.select(torch.from_numpy(rows), reqs, offset=offset)
    assert got.shape == (B, width) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_reciprocal_scale_is_what_matches():
    """A true division by the temperature differs from the reference's
    compiled fp32 reciprocal multiply on a share of the logits; the
    port's scale is the multiply, bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal(100_000).astype(np.float32)
    for t in (0.6, 0.7, 0.9, 1.3):
        want = np.asarray(jax.jit(lambda v, t=t: v / t)(jnp.asarray(x)))
        got = (torch.from_numpy(x) * SlotSampler(8, temperature=t)._inv_t)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (x / np.float32(t) != want).any()


def test_greedy_matches_argmax_golden():
    rng = np.random.default_rng(0)
    vocab, pad = 37, 48
    rows = rng.standard_normal((3, 2, pad)).astype(np.float32)
    s = SlotSampler(vocab)
    assert s.greedy
    got = s.select(torch.from_numpy(rows))
    np.testing.assert_array_equal(
        got.numpy(), ref_sampling.SlotSampler(vocab).select(
            jnp.asarray(rows)))


def test_top_k_never_escapes_the_top_k_set():
    rng = np.random.default_rng(1)
    vocab, k = 64, 5
    s = SlotSampler(vocab, temperature=0.8, top_k=k, seed=7)
    for trial in range(4):
        rows = rng.standard_normal((4, 3, vocab)).astype(np.float32)
        reqs = _fake_reqs(range(4), rng.integers(0, 20, size=4))
        toks = s.select(torch.from_numpy(rows), reqs, offset=trial).numpy()
        topk = np.argsort(rows, axis=-1)[..., -k:]
        for b in range(4):
            for i in range(3):
                assert toks[b, i] in topk[b, i], (b, i, trial)


def test_keys_depend_on_uid_and_index_not_slot():
    rng = np.random.default_rng(2)
    vocab = 64
    s = SlotSampler(vocab, temperature=1.0, seed=3)
    row = torch.from_numpy(rng.standard_normal((1, 1, vocab))
                           .astype(np.float32))
    rows2 = torch.cat([row, row])
    a = s.select(rows2, _fake_reqs([9, 42], [5, 0]))[0, 0]
    b = s.select(rows2, _fake_reqs([42, 9], [0, 5]))[1, 0]
    assert a == b
    c = s.select(row, _fake_reqs([9], [2]), offset=3)[0, 0]
    assert a == c
    stream5 = [int(s.select(row, _fake_reqs([9], [5 + i]))[0, 0])
               for i in range(8)]
    stream6 = [int(s.select(row, _fake_reqs([9], [6 + i]))[0, 0])
               for i in range(8)]
    assert stream5 != stream6


@pytest.mark.parametrize("args,kw", [
    ((0,), {}), ((8,), dict(temperature=-0.1)),
    ((8,), dict(temperature=1.0, top_k=-1))])
def test_sampler_validation_messages_match(args, kw):
    with pytest.raises(ValueError) as want:
        ref_sampling.SlotSampler(*args, **kw)
    with pytest.raises(ValueError) as got:
        SlotSampler(*args, **kw)
    assert str(got.value) == str(want.value)


# -- the engine ----------------------------------------------------------------


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_temp0_is_greedy_every_arch(arch):
    golden = _streams(arch)
    assert _streams(arch, temperature=0.0, top_k=0, sample_seed=99) == golden


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sampled_streams_equal_the_jax_engine_every_arch(arch):
    kw = dict(temperature=0.8, top_k=10, sample_seed=42)
    want = _streams(arch, jax_engine=True, **kw)
    got = _streams(arch, **kw)
    assert got == want
    assert got != _streams(arch)  # sampling moved them off greedy


def test_sampled_streams_reproducible_across_runs_and_schedulers():
    kw = dict(temperature=0.8, top_k=10, sample_seed=42)
    runs = {
        "cont-a": _streams("gpt2-124m", **kw),
        "cont-b": _streams("gpt2-124m", **kw),
        "chunked": _streams("gpt2-124m", prefill_chunk=4, **kw),
        "tight": _streams("gpt2-124m", max_batch=1, **kw),
    }
    first = runs["cont-a"]
    assert len(first) == 4 and all(first.values())
    for name, got in runs.items():
        assert got == first, name


def test_sampled_streams_move_with_the_seed():
    a = _streams("gpt2-124m", temperature=0.8, top_k=10, sample_seed=42)
    b = _streams("gpt2-124m", temperature=0.8, top_k=10, sample_seed=43)
    assert a != b
    assert a == _streams("gpt2-124m", temperature=0.8, top_k=10,
                         sample_seed=42)


def test_report_and_stats_carry_sampling_config(tmp_path):
    _, _, cfg, params = _model("gpt2-124m")
    eng = ServeEngine(cfg, params, max_batch=2, max_len=64, block_size=8,
                      temperature=0.7, top_k=5, sample_seed=9, device="cpu")
    assert (eng.temperature, eng.top_k, eng.sample_seed) == (0.7, 5, 9)
    for r in _traffic(cfg.vocab, Request, n=2, max_new=3):
        eng.submit(r)
    eng.run_until_drained()
    stats = eng.stats()
    for key in ("spec_k", "drafted_tokens", "accepted_tokens",
                "rejected_tokens", "draft_steps"):
        assert stats[key] == 0, key
    assert stats["acceptance_rate"] == 0.0
    assert stats["target_steps"] == stats["fused_steps"]
    out = tmp_path / "report.json"
    assert serve_cli.main(["--device", "cpu", "--requests", "2",
                           "--max-new", "3", "--temperature", "0.8",
                           "--top-k", "20", "--sample-seed", "5", "--out",
                           str(out)]) == 0
    report = json.loads(out.read_text())
    assert (report["temperature"], report["top_k"],
            report["sample_seed"]) == (0.8, 20, 5)
