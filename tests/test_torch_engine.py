"""The port's serving engine against ``repro.serve.engine``.

With the reference's weights carried across by ``params_from_numpy``, the
port's greedy streams must equal the JAX engine's token for token on
ragged traffic, for gpt2-smoke and qwen3-1.7b-smoke.  The rest mirrors the
reference's engine contract (``tests/test_serve_engine.py``) inside the
port: batched == single, EOS refills a slot mid-flight, blocks recycle,
preemption replays the same stream, oversized requests fail at submit,
and ``stats()`` carries the reference's keys.
"""

import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.serve import engine as ref_engine  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.engine import (Request, RequestTooLong,  # noqa: E402
                                      ServeEngine)
import torch_threads  # noqa: E402

torch_threads.use_threads(2)


@pytest.fixture(scope="module", params=["gpt2-124m", "qwen3-1.7b"])
def arch_setup(request):
    rcfg = ref_configs.get_smoke_config(request.param)
    cfg = port_configs.get_smoke_config(request.param)
    ref_params = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
    params = transformer.params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    return rcfg, ref_params, cfg, params


@pytest.fixture(scope="module")
def gpt2():
    cfg = port_configs.get_smoke_config("gpt2-124m")
    return cfg, transformer.init_lm(cfg, seed=0, device="cpu")


def _prompts(seed, n, lo=3, hi=13, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


def _serve(engine_cls, request_cls, cfg, params, prompts, max_new=5,
           eos=None, **kw):
    eng = engine_cls(cfg, params, **kw)
    for uid, p in enumerate(prompts):
        eng.submit(request_cls(uid=uid, prompt=p.copy(),
                               max_new_tokens=max_new,
                               eos_id=(eos or {}).get(uid, -1)))
    eng.run_until_drained()
    return eng


def test_greedy_streams_equal_the_reference_engine(arch_setup):
    rcfg, ref_params, cfg, params = arch_setup
    prompts = _prompts(0, 7)
    kw = dict(max_batch=3, max_len=32, block_size=8)
    ref = _serve(ref_engine.ServeEngine, ref_engine.Request, rcfg,
                 ref_params, prompts, **kw)
    port = _serve(ServeEngine, Request, cfg, params, prompts, device="cpu",
                  **kw)
    for uid in range(len(prompts)):
        assert port.completed[uid].generated == \
            ref.completed[uid].generated, uid
    assert port.steps == ref.steps
    assert port.busy_slot_steps == ref.busy_slot_steps
    assert port.block_history == ref.block_history
    assert set(port.stats()) == set(ref.stats())


def test_batched_matches_single(gpt2):
    cfg, params = gpt2
    prompts = _prompts(1, 3)
    singles = [
        _serve(ServeEngine, Request, cfg, params, [p], max_new=6,
               max_batch=1, max_len=96, device="cpu").completed[0].generated
        for p in prompts
    ]
    batched = _serve(ServeEngine, Request, cfg, params, prompts, max_new=6,
                     max_batch=3, max_len=96, device="cpu")
    for uid in range(3):
        assert batched.completed[uid].generated == singles[uid], uid


def test_early_eos_refills_slot_mid_flight(gpt2):
    cfg, params = gpt2
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32)
               for n in (5, 12, 6)]
    first = _serve(ServeEngine, Request, cfg, params, prompts[:1], max_new=1,
                   max_batch=1, max_len=32, block_size=8,
                   device="cpu").completed[0].generated[0]
    eng = _serve(ServeEngine, Request, cfg, params, prompts, max_new=8,
                 eos={0: first}, max_batch=2, max_len=32, block_size=8,
                 device="cpu")
    done = eng.completed
    assert len(done) == 3 and done[0].generated == [first]
    # uid 2 took uid 0's slot before uid 1 finished, and its blocks
    assert done[2].started_s < done[1].finished_s
    assert set(eng.block_history[2]) & set(eng.block_history[0])


def test_preempt_replays_the_same_stream(gpt2):
    cfg, params = gpt2
    prompts = _prompts(5, 3, lo=5, hi=9)
    base = _serve(ServeEngine, Request, cfg, params, prompts, max_new=6,
                  max_batch=2, max_len=32, block_size=8, device="cpu")
    fired = []

    def hook(engine, busy):
        live = engine._live
        for b, r in enumerate(live["slot_req"]):
            if (not fired and r is not None and r.uid == 1
                    and len(r.generated) == 2):
                fired.append(engine.preempt(uid=1))
        return False

    eng = ServeEngine(cfg, params, max_batch=2, max_len=32, block_size=8,
                      device="cpu")
    eng.add_step_hook(hook)
    for uid, p in enumerate(prompts):
        eng.submit(Request(uid=uid, prompt=p.copy(), max_new_tokens=6))
    eng.run_until_drained()
    assert fired == [1] and eng.preemptions == 1
    for uid in range(3):
        assert eng.completed[uid].generated == base.completed[uid].generated


def test_request_too_long_rejected_at_submit(gpt2):
    cfg, params = gpt2
    eng = ServeEngine(cfg, params, max_batch=2, max_len=32, device="cpu")
    with pytest.raises(RequestTooLong):
        eng.submit(Request(uid=0, prompt=np.arange(20, dtype=np.int32),
                           max_new_tokens=20))
    assert not eng.queue
    eng.submit(Request(uid=1, prompt=np.arange(4, dtype=np.int32),
                       max_new_tokens=3))
    done = eng.run_until_drained()
    assert list(done) == [1] and len(done[1].generated) == 3
    stats = eng.stats()
    assert stats["requests"] == 1 and stats["new_tokens"] == 3
    assert stats["fused_steps"] == eng.steps == 4 + 3 - 1


_NO_DRAFT = (r"^speculative decoding \(spec_k > 0\) requires a draft model: "
             r"pass draft_cfg and draft_params$")


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(scheduler="wave"), None, id="kw0-1.12"),
    pytest.param(dict(spec_k=2), _NO_DRAFT, id="kw1-1.13"),
    pytest.param(dict(mesh=MeshShape(1, 1), spec_k=2), _NO_DRAFT,
                 id="kw2-1.13"),
])
def test_unported_options_name_their_roadmap_item(gpt2, kw, match):
    """The wave scheduler (1.12) is ported: a wave engine builds and
    serves.  Speculative decoding (1.13) is ported: ``spec_k`` without a
    draft model gets the reference's message, with a mesh or without."""
    cfg, params = gpt2
    if match is None:
        eng = ServeEngine(cfg, params, device="cpu", **kw)
        eng.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                           max_new_tokens=3))
        done = eng.run_until_drained()
        assert eng.scheduler == "wave" and len(done[0].generated) == 3
        assert eng.steps == 4 + 3 - 1
        return
    with pytest.raises(ValueError, match=match):
        ServeEngine(cfg, params, device="cpu", **kw)


@pytest.mark.parametrize("kw", [dict(prefill_chunk=4),
                                dict(prefill_budget=8)])
def test_chunked_prefill_options_are_served(gpt2, kw):
    """Chunked prefill (ROADMAP 1.9) is ported: the options the refusal
    cases above used to name are served, with the token-by-token streams."""
    cfg, params = gpt2
    prompts = _prompts(6, 3, lo=5, hi=14)
    base = _serve(ServeEngine, Request, cfg, params, prompts, max_batch=2,
                  max_len=32, block_size=8, device="cpu")
    eng = _serve(ServeEngine, Request, cfg, params, prompts, max_batch=2,
                 max_len=32, block_size=8, device="cpu", **kw)
    for uid in range(len(prompts)):
        assert eng.completed[uid].generated == base.completed[uid].generated
    assert eng.stats()["prefill_chunk"] == kw.get("prefill_chunk", 1)
    assert eng.stats()["prefill_budget"] == kw.get("prefill_budget")


@pytest.mark.parametrize("kw", [dict(kv_dtype="bf16"), dict(kv_dtype="int8"),
                                dict(share_prefixes=True)])
def test_quantized_and_sharing_options_are_served(gpt2, kw):
    """Quantized paging and prefix sharing (ROADMAP 1.11) are ported: the
    options the refusal cases above used to name are served, and
    ``stats()`` reports them; sharing alone keeps the f32 streams."""
    cfg, params = gpt2
    prompts = _prompts(6, 3, lo=5, hi=14)
    base = _serve(ServeEngine, Request, cfg, params, prompts, max_batch=2,
                  max_len=32, block_size=8, device="cpu")
    eng = _serve(ServeEngine, Request, cfg, params, prompts, max_batch=2,
                 max_len=32, block_size=8, device="cpu", **kw)
    assert all(len(eng.completed[u].generated) == 5 for u in range(3))
    stats = eng.stats()
    assert stats["kv_dtype"] == kw.get("kv_dtype", "f32")
    assert stats["share_prefixes"] == kw.get("share_prefixes", False)
    if "kv_dtype" not in kw:
        for uid in range(len(prompts)):
            assert eng.completed[uid].generated == \
                base.completed[uid].generated
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeEngine(cfg, params, kv_dtype="fp8", device="cpu")


def test_non_dense_arch_and_sampling_are_refused(gpt2):
    """Encoder-decoder archs (1.18) are refused.  Sampling (1.13) is
    ported: ``temperature > 0`` serves sampled streams, and a negative
    temperature gets the reference's message."""
    cfg, params = gpt2
    with pytest.raises(ValueError, match=r"1\.18"):
        ServeEngine(dataclasses.replace(cfg, is_encoder_decoder=True),
                    params, device="cpu")
    prompts = _prompts(7, 3)
    greedy = _serve(ServeEngine, Request, cfg, params, prompts, max_batch=2,
                    max_len=32, block_size=8, device="cpu")
    sampled = _serve(ServeEngine, Request, cfg, params, prompts, max_batch=2,
                     max_len=32, block_size=8, device="cpu",
                     temperature=0.7, sample_seed=3)
    assert all(len(r.generated) == 5 for r in sampled.completed.values())
    assert [r.generated for r in sampled.completed.values()] != \
        [r.generated for r in greedy.completed.values()]
    with pytest.raises(ValueError, match=r"^temperature must be >= 0 "
                       r"\(0 = greedy\), got -0\.7$"):
        ServeEngine(cfg, params, temperature=-0.7, device="cpu")


def test_engine_refuses_params_on_another_device_or_no_card(gpt2):
    cfg, params = gpt2
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        ServeEngine(cfg, params)  # the default device is cuda
    moved = dict(params, embed={"embedding":
                                params["embed"]["embedding"].to("meta")})
    with pytest.raises(ValueError, match="params lie on"):
        ServeEngine(cfg, moved, device="cpu")


def test_scheduler_arrays_reach_the_step_as_private_copies(gpt2):
    """The step's position/table tensors must not alias the host arrays
    the drain mutates right after dispatch."""
    cfg, params = gpt2
    eng = ServeEngine(cfg, params, device="cpu")
    host = np.zeros(4, np.int32)
    dev = eng._dev(host)
    host[:] = 7
    assert dev.tolist() == [0, 0, 0, 0]
