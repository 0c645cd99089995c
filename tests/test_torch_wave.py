"""The port's wave scheduler against ``repro.serve.engine``'s, mirroring
the wave cases of ``tests/test_serve_engine.py``, ``tests/test_sampling.py``
and ``tests/test_sharded_serve.py``.

On the reference's weights the port's wave engine serves the JAX wave
engine's streams in its fused steps, busy slot-steps and TTFT steps, with
its stats (gpt2-124m, qwen3-1.7b and deepseek-moe-16b here; the archs
with state or latent caches in ``tests/test_torch_wave_stateful.py``).
The port's continuous engine serves the same streams in fewer steps.
Waves drain a long queue, sampled streams are the same under every
scheduler, a wave serves at a ``max_len`` that is no multiple of the
TPU kernel's tile, and every wave option the reference refuses is
refused with its message.
"""

import json

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import engine as ref_engine  # noqa: E402
from repro_torch.examples import serve_lm  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serve.engine import (Request, RequestTooLong,  # noqa: E402
                                      ServeEngine)
import torch_dense_checks as checks  # noqa: E402
from torch_stateful_checks import model  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)


@pytest.mark.parametrize("arch,tight", [
    ("gpt2-124m", False), ("qwen3-1.7b", False),
    ("deepseek-moe-16b", False), ("deepseek-moe-16b", True)])
def test_wave_matches_the_jax_wave_engine(arch, tight):
    checks.check_wave(arch, tight_moe=tight)


def _engine(scheduler="wave", **kw):
    m = model("gpt2-124m")
    kw = {**checks.WAVE_KW, **kw}
    return ServeEngine(m.cfg, m.params, scheduler=scheduler, device="cpu",
                       **kw)


def _single(prompt, max_new):
    eng = _engine(max_batch=1)
    eng.submit(Request(uid=0, prompt=prompt, max_new_tokens=max_new))
    return eng.run_until_drained()[0].generated


def test_continuous_matches_wave_with_fewer_steps():
    """The reference's golden equivalence (``tests/test_serve_engine.py``):
    ragged prompts and one request that ends on its first token give equal
    streams, strictly fewer fused steps and strictly higher slot
    utilization under the continuous scheduler."""
    prompts = checks.wave_prompts(256)
    eos0 = _single(prompts[0], 1)[0]
    engines = {}
    for sched in ("wave", "continuous"):
        eng = _engine(sched)
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p.copy(), max_new_tokens=6,
                               eos_id=eos0 if uid == 0 else -1))
        eng.run_until_drained()
        engines[sched] = eng
    wave, cont = engines["wave"], engines["continuous"]
    for uid in range(6):
        assert cont.completed[uid].generated == \
            wave.completed[uid].generated, uid
    assert cont.completed[0].generated == [eos0]
    assert cont.steps < wave.steps
    assert cont.slot_utilization > wave.slot_utilization


def test_batched_wave_matches_single():
    prompts = checks.wave_prompts(256, seed=0, n=3)
    singles = [_single(p, 6) for p in prompts]
    eng = checks.serve(_engine(max_batch=3, max_len=96), Request, prompts)
    assert [eng.completed[u].generated for u in range(3)] == singles


def test_queue_drains_multiple_waves():
    rng = np.random.default_rng(1)
    eng = _engine()
    for uid in range(5):
        eng.submit(Request(uid=uid, prompt=rng.integers(0, 256, size=4)
                           .astype(np.int32), max_new_tokens=3))
    done = eng.run_until_drained()
    assert len(done) == 5
    assert all(len(r.generated) == 3 for r in done.values())
    assert eng.steps == 3 * (4 + 3 - 1)  # three waves of 6 steps


def _hooked(engine_cls, request_cls, params, cfg, **kw):
    """A wave engine whose hook submits one request on its first call:
    it lands in the wave after the one that is running."""
    eng = engine_cls(cfg, params, scheduler="wave", **checks.WAVE_KW, **kw)
    calls = []

    def hook(engine, busy):
        calls.append(busy)
        if len(calls) == 3:
            engine.submit(request_cls(uid=9, prompt=np.arange(
                5, dtype=np.int32), max_new_tokens=4))
        return False

    eng.add_step_hook(hook)
    checks.serve(eng, request_cls, checks.wave_prompts(cfg.vocab, n=2))
    return calls, checks.summary(eng)


def test_step_hooks_and_arrivals_match_the_reference():
    m = model("gpt2-124m")
    want = _hooked(ref_engine.ServeEngine, ref_engine.Request, m.rp, m.rcfg)
    got = _hooked(ServeEngine, Request, m.params, m.cfg, device="cpu")
    assert got == want
    calls, summary = got
    # busy=False before each of the two waves and once at the end
    assert calls[0] is False and calls[-1] is False
    assert calls.count(False) == 3
    assert set(summary["streams"]) == {0, 1, 9}


def _sampled(engine_cls, request_cls, params, cfg, **kw):
    eng = engine_cls(cfg, params, max_batch=2, max_len=64, block_size=8,
                     temperature=0.8, top_k=10, sample_seed=42, **kw)
    rng = np.random.default_rng(11)
    for i in range(4):
        eng.submit(request_cls(uid=i, prompt=rng.integers(
            1, cfg.vocab, size=int(rng.integers(3, 9))).astype(np.int32),
            max_new_tokens=6))
    eng.run_until_drained()
    return {u: r.generated for u, r in eng.completed.items()}


def test_sampled_streams_equal_across_schedulers_and_the_reference():
    """``tests/test_sampling.py``: a request's sampled stream depends on
    its uid and index only, so wave, continuous and chunked engines serve
    the same streams, and the port's wave serves the JAX wave's."""
    m = model("gpt2-124m")
    runs = {
        "wave": _sampled(ServeEngine, Request, m.params, m.cfg,
                         scheduler="wave", device="cpu"),
        "continuous": _sampled(ServeEngine, Request, m.params, m.cfg,
                               device="cpu"),
        "chunked": _sampled(ServeEngine, Request, m.params, m.cfg,
                            prefill_chunk=4, device="cpu"),
        "jax-wave": _sampled(ref_engine.ServeEngine, ref_engine.Request,
                             m.rp, m.rcfg, scheduler="wave"),
    }
    assert len(runs["wave"]) == 4 and all(runs["wave"].values())
    for name, got in runs.items():
        assert got == runs["wave"], name


def _jax_mesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=4), dict(kv_dtype="bf16"), dict(kv_dtype="int8"),
    dict(share_prefixes=True), dict(spec_k=2, draft=True),
    dict(mesh=True), dict(scheduler="lockstep"),
], ids=["chunked", "bf16", "int8", "sharing", "speculative", "mesh",
        "unknown"])
def test_wave_refusals_carry_the_reference_messages(kw):
    m = model("gpt2-124m")
    kw = {"scheduler": "wave", **kw}
    ref_kw, port_kw = dict(kw), dict(kw, device="cpu")
    if kw.pop("draft", None):
        for d, params, cfg in ((ref_kw, m.rp, m.rcfg),
                               (port_kw, m.params, m.cfg)):
            del d["draft"]
            d.update(draft_cfg=cfg, draft_params=params)
    if "mesh" in kw:
        ref_kw["mesh"], port_kw["mesh"] = _jax_mesh(), MeshShape(1, 1)
    with pytest.raises(ValueError) as want:
        ref_engine.ServeEngine(m.rcfg, m.rp, **ref_kw)
    with pytest.raises(ValueError) as got:
        ServeEngine(m.cfg, m.params, **port_kw)
    assert str(got.value) == str(want.value)


def test_preempt_under_the_wave_scheduler_raises():
    eng = _engine()
    seen = []

    def hook(engine, busy):
        with pytest.raises(RuntimeError, match=r"^preempt\(\) is only "
                           r"available from a step hook while the "
                           r"continuous scheduler is draining$"):
            engine.preempt()
        seen.append(busy)
        return False

    eng.add_step_hook(hook)
    checks.serve(eng, Request, checks.wave_prompts(256, n=2), max_new=2)
    assert seen and eng.preemptions == 0


def test_wave_serves_a_max_len_off_the_tpu_tile():
    """The wave engine takes any ``max_len`` (600: no multiple of the TPU
    kernel's 512-row tile, nor of the block size, which only the
    continuous scheduler checks) and serves the JAX wave's streams."""
    m = model("gpt2-124m")
    kw = dict(max_batch=2, max_len=600, block_size=16)
    with pytest.raises(ValueError, match="^max_len 600 must be a multiple "
                       "of block_size 16$"):
        ServeEngine(m.cfg, m.params, device="cpu", **kw)
    prompts = checks.wave_prompts(256, n=2)
    want = checks.summary(checks.serve(ref_engine.ServeEngine(
        m.rcfg, m.rp, scheduler="wave", **kw), ref_engine.Request, prompts))
    got = checks.summary(checks.serve(ServeEngine(
        m.cfg, m.params, scheduler="wave", device="cpu", **kw), Request,
        prompts))
    assert got == want


def test_wave_warmup_stats_and_oversized_requests():
    eng = _engine()
    eng.warmup()
    assert eng.steps == 0 and eng.busy_slot_steps == 0
    with pytest.raises(RequestTooLong):
        eng.submit(Request(uid=0, prompt=np.arange(60, dtype=np.int32),
                           max_new_tokens=5))
    checks.serve(eng, Request, checks.wave_prompts(256, n=2), max_new=3)
    m = model("gpt2-124m")
    ref = ref_engine.ServeEngine(m.rcfg, m.rp, scheduler="wave")
    stats = eng.stats()
    assert set(stats) == set(ref.stats())
    assert stats["scheduler"] == "wave" and stats["requests"] == 2
    assert stats["logical_blocks"] == stats["physical_blocks"] == 0


def test_dense_entry_points_refuse_what_they_lack():
    m = model("gpt2-124m")
    tok = torch.zeros((1, 4), dtype=torch.int32)
    for fn in (transformer.forward, transformer.prefill):
        with pytest.raises(ValueError, match="unknown remat policy 'some'"):
            fn(m.params, m.cfg, tok, remat="some")
    _, cache = transformer.prefill(m.params, m.cfg, tok)
    with pytest.raises(ValueError, match="no room for a token at "
                       "position 4"):
        transformer.decode_step(m.params, m.cfg, tok[:, :1], cache)
    cache = transformer.init_cache(m.cfg, 1, 8, "cpu")
    cache["k"] = cache["k"].bfloat16()
    with pytest.raises(TypeError, match="q's dtype"):
        transformer.decode_step(m.params, m.cfg, tok[:, :1], cache)


def test_cli_serves_the_wave_scheduler(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert serve_cli.main(["--device", "cpu", "--scheduler", "wave",
                           "--requests", "3", "--max-new", "4",
                           "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert "[wave] served 3 requests, 12 tokens" in capsys.readouterr().out
    assert report["scheduler"] == report["stats"]["scheduler"] == "wave"
    assert [r["new_tokens"] for r in report["requests"]] == [4, 4, 4]


def test_example_runs_on_the_cpu(capsys):
    assert serve_lm.main(["--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "[wave] served 10 requests" in printed
    assert "[continuous] served 10 requests" in printed
    assert "fewer fused steps than lockstep" in printed
