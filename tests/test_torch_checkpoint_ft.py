"""The port's checkpoint store and fault-tolerance loop, mirroring
``tests/test_checkpoint_ft.py``: atomic commits, keep-newest GC, the
async writer, placement on restore, crash-restart with exact replay,
straggler detection, and a serve drain killed mid-chunk that resumes
bit-identically on the port's engine.

Beyond the mirror: a bf16 state round-trips bit for bit, a host copy is
taken before ``save`` returns, and each package reads a checkpoint the
other wrote (f32 and int32), so the flat paths and the layout are the
reference's.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointStore as RefStore  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    FaultToleranceConfig,
    ResilientLoop,
    StragglerDetector,
)


def _state(x=0.0):
    return {"w": torch.full((4, 4), x, dtype=torch.float32),
            "step_f": torch.tensor(x)}


def test_save_restore_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path))
    s = _state(3.5)
    store.save(7, s)
    step, restored, manifest = store.restore(_state())
    assert step == 7
    assert torch.equal(restored["w"], s["w"])


def test_uncommitted_checkpoint_invisible(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(1, _state(1.0))
    # simulate a crash mid-write: a step dir without the commit marker
    crash = tmp_path / "step_00000002"
    crash.mkdir()
    (crash / "arrays.npz").write_bytes(b"garbage")
    assert store.latest_step() == 1
    step, restored, _ = store.restore(_state())
    assert step == 1


def test_gc_keeps_newest_k(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        store.save(s, _state(float(s)))
    assert store.committed_steps() == [3, 4]


def test_async_save_then_restore(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(5, _state(5.0), blocking=False)
    store.wait()
    assert store.latest_step() == 5


def test_save_copies_to_the_host_before_it_returns(tmp_path):
    """The writer thread serializes a copy: changing the state in place
    right after ``save`` returns changes nothing on disk."""
    store = CheckpointStore(str(tmp_path))
    s = {"w": torch.full((64, 64), 1.0), "n": np.arange(5, dtype=np.int32)}
    store.save(1, s, blocking=False)
    s["w"].fill_(2.0)
    s["n"][:] = -1
    _, restored, _ = store.restore({"w": torch.zeros(64, 64),
                                    "n": np.zeros(5, np.int32)})
    assert torch.equal(restored["w"], torch.full((64, 64), 1.0))
    np.testing.assert_array_equal(restored["n"], np.arange(5))


def test_restore_missing_raises(tmp_path):
    store = CheckpointStore(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        store.restore(_state())


def test_restore_shape_mismatch_raises(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(1, _state())
    bad_template = {"w": torch.zeros((2, 2)), "step_f": torch.tensor(0.0)}
    with pytest.raises(ValueError, match="shape"):
        store.restore(bad_template)
    with pytest.raises(KeyError, match="missing array 'v'"):
        store.restore({"v": torch.zeros(4, 4)})


def test_elastic_restore_onto_device(tmp_path):
    """Restore places every array on the device asked for, else on the
    template leaf's device; numpy template leaves come back as numpy."""
    store = CheckpointStore(str(tmp_path))
    store.save(2, {"w": _state(2.0)["w"], "n": np.arange(3)})
    _, on_dev, _ = store.restore({"w": torch.zeros(4, 4),
                                  "n": np.zeros(3, np.int64)},
                                 device=torch.device("cpu"))
    assert isinstance(on_dev["n"], torch.Tensor)
    assert on_dev["w"].device == torch.device("cpu")
    _, like, _ = store.restore({"w": torch.zeros(4, 4),
                                "n": np.zeros(3, np.int64)})
    assert isinstance(like["w"], torch.Tensor)
    assert isinstance(like["n"], np.ndarray)


def test_bf16_round_trip_is_bit_exact(tmp_path):
    gen = torch.Generator().manual_seed(0)
    w = (torch.randn(33, 17, generator=gen) * 1e3).to(torch.bfloat16)
    w[0, :4] = torch.tensor([float("inf"), float("-inf"), float("nan"),
                             -0.0]).to(torch.bfloat16)
    store = CheckpointStore(str(tmp_path))
    store.save(3, {"layers": [{"w": w}, {"w": w[:2]}]})
    _, back, _ = store.restore({"layers": [{"w": torch.zeros_like(w)},
                                           {"w": torch.zeros(2, 17)}]})
    for got, want in ((back["layers"][0]["w"], w), (back["layers"][1]["w"],
                                                    w[:2])):
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    import json

    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["arrays"]["layers/0/w"]["dtype"] == "bfloat16"


def _mixed(x):
    """A nested tree of f32 and int32 leaves in dicts and lists."""
    return {"params": {"b": np.full((3,), x, np.float32),
                       "a": [np.arange(4, dtype=np.int32) + int(x),
                             np.eye(2, dtype=np.float32) * x]},
            "count": np.asarray(int(x), np.int32)}


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    ref = _mixed(5.0)
    RefStore(str(tmp_path)).save(
        4, {"params": {"b": jnp.asarray(ref["params"]["b"]),
                       "a": [jnp.asarray(a) for a in ref["params"]["a"]]},
            "count": jnp.asarray(ref["count"])}, extra={"data_step": 4})
    store = CheckpointStore(str(tmp_path))
    assert store.latest_step() == 4
    step, got, extra = store.restore(_mixed(0.0))
    assert step == 4 and extra == {"data_step": 4}
    assert got["params"]["a"][0].dtype == np.int32
    for a, b in ((got["params"]["b"], ref["params"]["b"]),
                 (got["params"]["a"][0], ref["params"]["a"][0]),
                 (got["params"]["a"][1], ref["params"]["a"][1]),
                 (got["count"], ref["count"])):
        np.testing.assert_array_equal(a, b)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    port = _mixed(7.0)
    state = dict(port, t=torch.arange(6, dtype=torch.int32).reshape(2, 3))
    CheckpointStore(str(tmp_path)).save(9, state)
    template = dict(_mixed(0.0), t=np.zeros((2, 3), np.int32))
    step, got, _ = RefStore(str(tmp_path)).restore(template)
    assert step == 9
    np.testing.assert_array_equal(np.asarray(got["params"]["b"]),
                                  port["params"]["b"])
    np.testing.assert_array_equal(np.asarray(got["params"]["a"][0]),
                                  port["params"]["a"][0])
    assert np.asarray(got["t"]).dtype == np.int32
    np.testing.assert_array_equal(np.asarray(got["t"]),
                                  np.arange(6).reshape(2, 3))
    # the same files on disk as the reference's own
    assert sorted(os.listdir(tmp_path / "step_00000009")) == [
        "_COMMITTED", "arrays.npz", "manifest.json"]


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------


class _Flaky:
    """Step function that crashes at chosen steps, once each."""

    def __init__(self, fail_at):
        self.fail_at = set(fail_at)
        self.calls = 0

    def __call__(self, step, state):
        self.calls += 1
        if step in self.fail_at:
            self.fail_at.remove(step)
            raise RuntimeError(f"injected failure @ {step}")
        return {"w": state["w"] + 1.0, "step_f": state["step_f"]}


def test_resilient_loop_survives_crashes(tmp_path):
    store = CheckpointStore(str(tmp_path))
    cfg = FaultToleranceConfig(checkpoint_every=2, async_save=False,
                               max_restarts=5)
    flaky = _Flaky(fail_at=[3, 7])
    loop = ResilientLoop(store, cfg, flaky, lambda: _state(0.0))
    out = loop.run(total_steps=10)
    assert out["final_step"] == 10
    assert out["restarts"] == 2
    # exact replay: w counts every step exactly once despite the crashes
    assert torch.equal(out["state"]["w"], torch.full((4, 4), 10.0))


def test_resilient_loop_gives_up_after_max_restarts(tmp_path):
    store = CheckpointStore(str(tmp_path))
    cfg = FaultToleranceConfig(checkpoint_every=100, async_save=False,
                               max_restarts=2)

    def always_fail(step, state):
        raise RuntimeError("dead node")

    loop = ResilientLoop(store, cfg, always_fail, lambda: _state(0.0))
    with pytest.raises(RuntimeError):
        loop.run(total_steps=5)


def test_resilient_loop_resumes_from_disk(tmp_path):
    """A brand-new loop object (fresh process analogue) picks up the latest
    committed checkpoint, placed on the loop's device."""
    store = CheckpointStore(str(tmp_path))
    cfg = FaultToleranceConfig(checkpoint_every=2, async_save=False)
    step_fn = lambda step, st: {"w": st["w"] + 1.0,  # noqa: E731
                                "step_f": st["step_f"]}
    ResilientLoop(store, cfg, step_fn, lambda: _state(0.0)).run(
        total_steps=4)

    loop2 = ResilientLoop(store, cfg, step_fn, lambda: _state(0.0),
                          device="cpu")
    out = loop2.run(total_steps=8)
    assert out["final_step"] == 8
    assert torch.equal(out["state"]["w"], torch.full((4, 4), 8.0))


def test_resilient_loop_frees_the_failed_state_before_it_restores(tmp_path):
    """On a restart the failed step's state is gone before the template is
    built, and with a device the restore gets a template of shapes only
    (meta tensors), so the device never holds two states at once."""
    import weakref

    store = CheckpointStore(str(tmp_path))
    cfg = FaultToleranceConfig(checkpoint_every=2, async_save=False)
    failed, freed, templates = [], [], []

    def step_fn(step, st):
        if step == 3 and not failed:
            failed.append(weakref.ref(st["w"]))
            raise RuntimeError("injected failure @ 3")
        return {"w": st["w"] + 1.0, "step_f": st["step_f"]}

    def make_initial_state():
        freed.append(all(ref() is None for ref in failed))
        return _state(0.0)

    restore = store.restore

    def spy(template, **kw):
        templates.append(template["w"].device.type)
        return restore(template, **kw)

    store.restore = spy
    out = ResilientLoop(store, cfg, step_fn, make_initial_state,
                        device="cpu").run(total_steps=6)
    assert out["restarts"] == 1
    assert torch.equal(out["state"]["w"], torch.full((4, 4), 6.0))
    assert out["state"]["w"].device.type == "cpu"
    assert freed == [True, True]
    assert templates == ["meta"]


def test_straggler_detector():
    det = StragglerDetector(factor=2.0, window=16)
    for _ in range(10):
        det.observe(0.1)
    assert det.observe(0.5) is True
    assert det.events == 1
    assert det.observe(0.11) is False


# ---------------------------------------------------------------------------
# fault tolerance under the serve path
# ---------------------------------------------------------------------------


def test_serve_restart_resumes_bit_identical_token_stream(tmp_path):
    """Kill the port's serve drain mid-chunk, restore from the checkpoint
    store, and assert the resumed token stream bit-matches the
    uninterrupted golden run — the serving analogue of exact training
    replay."""
    import repro_torch.configs as configs
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = configs.get_smoke_config("gpt2-124m")
    params = transformer.init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(4, 10)))
               .astype(np.int32) for _ in range(4)]

    def engine():
        return ServeEngine(cfg, params, max_batch=2, max_len=32,
                           scheduler="continuous", block_size=8,
                           device="cpu")

    def serve_all():
        """Uninterrupted golden run: one engine, all requests."""
        eng = engine()
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=4))
        return {u: r.generated for u, r in eng.run_until_drained().items()}

    golden = serve_all()

    # resilient run: 2-request chunks, each chunk one checkpointed step;
    # the second chunk's first attempt dies mid-drain
    chunks = [(0, 1), (2, 3)]
    crashed = {"left": 1}

    def step_fn(chunk_idx, state):
        eng = engine()
        for uid in chunks[chunk_idx]:
            eng.submit(Request(uid=uid, prompt=prompts[uid],
                               max_new_tokens=4))

        def killer(e, busy):
            if chunk_idx == 1 and crashed["left"] and e.steps >= 2:
                crashed["left"] -= 1
                raise RuntimeError("simulated device loss mid-drain")
            return False

        eng.add_step_hook(killer)
        done = eng.run_until_drained()
        toks = np.array(state["tokens"])
        for uid, r in done.items():
            toks[uid, : len(r.generated)] = r.generated
        return {"tokens": toks}

    loop = ResilientLoop(
        CheckpointStore(str(tmp_path)),
        FaultToleranceConfig(checkpoint_every=1, async_save=False,
                             max_restarts=3),
        step_fn,
        lambda: {"tokens": np.full((4, 4), -1, np.int32)},
    )
    out = loop.run(total_steps=len(chunks))
    assert out["restarts"] == 1, "the injected death must actually fire"
    resumed = np.asarray(out["state"]["tokens"])
    for uid, toks in golden.items():
        assert resumed[uid].tolist() == toks, (
            f"req {uid}: resumed stream {resumed[uid].tolist()} != "
            f"golden {toks}"
        )
