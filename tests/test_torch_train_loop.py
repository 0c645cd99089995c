"""The port's training loop, ``launch/train.py`` and
``examples/train_lm.py``, mirroring ``tests/test_optim_train.py``: the
loss falls on a fixed batch, 4 microbatches equal 1 (and the reference's
4), a resume from the port's checkpoint store is an exact replay, the
in-place (donated) step equals the functional one, ``train`` survives an
injected fault through the resilient loop with final params bit-equal to
a run without it while holding one state at a time, and the CLI and the
example run on ``--device cpu``.
The reference's mesh train step fails on this tree, so the port's mesh
path is held only to its refusal of a model axis above 1.

Tolerances: the reference's microbatch bound (loss rtol 1e-5, params rtol
1e-4 and atol 1e-5), and bit-equality for replays on the CPU.  The replays
run on one thread: on several, torch's CPU step is not bit-for-bit
repeatable from one run to the next (two unfaulted runs of gpt2-124m's
smoke config on 8 threads part by 3e-8), whatever the checkpoints do.
"""

import time

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import steps as ref_steps  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.launch.mesh import MeshShapeError  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.scenarios.faults import SimulatedDeviceLoss  # noqa: E402
from repro_torch.train import steps  # noqa: E402
import torch_threads  # noqa: E402
import torch_train_checks as checks  # noqa: E402

torch_threads.use_threads(2)

#: the reference's ``SMOKE`` train shape in tests/test_optim_train.py
SEQ, BATCH = 32, 4


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _setup(microbatches=1, **run_kw):
    a = checks.arch("gpt2-124m")
    run = steps.RunConfig(remat="none",
                          microbatches=microbatches, **run_kw)
    params = a.params()
    return a, run, params, adamw.init_opt_state(params, run.opt)


def _batch(a, step, seed=0):
    return checks.to_torch(checks.fixed_batch(a, step, SEQ, BATCH, seed))


def test_loss_decreases_over_20_steps():
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=1000)
    a, run, params, opt = _setup(opt=opt_cfg)
    ts = steps.make_train_step(a.cfg, run)
    batch = _batch(a, 0)  # fixed batch: memorize
    losses = []
    for _ in range(20):
        params, opt, m = ts(params, opt, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_microbatch_accumulation_matches_single_shot_and_the_reference():
    a, run1, p1, o1 = _setup(microbatches=1)
    _, run4, p4, o4 = _setup(microbatches=4)
    batch = _batch(a, 0)
    p1n, _, m1 = steps.make_train_step(a.cfg, run1)(p1, o1, batch)
    p4n, o4n, m4 = steps.make_train_step(a.cfg, run4)(p4, o4, batch)
    np.testing.assert_allclose(float(m1["loss"]), float(m4["loss"]),
                               rtol=1e-5)
    checks.assert_trees_close(p4n, p1n, "params", rtol=1e-4, atol=1e-5)
    # and the reference's own four microbatches
    rrun = ref_steps.RunConfig(remat="none", zero=False, microbatches=4)
    rp, ro, rm = jax.jit(ref_steps.make_train_step(a.rcfg, rrun))(
        a.rparams, ref_adamw.init_opt_state(a.rparams, rrun.opt),
        checks.to_jax(checks.fixed_batch(a, 0, SEQ, BATCH)))
    np.testing.assert_allclose(float(m4["loss"]), float(rm["loss"]),
                               rtol=1e-5)
    checks.assert_trees_close(p4n, checks.as_port_tree(a, rp), "params",
                              rtol=1e-4, atol=1e-5)
    checks.assert_trees_close(o4n["m"], checks.as_port_tree(a, ro["m"]),
                              "m", rtol=1e-4, atol=1e-5)


def test_microbatches_must_divide_the_batch():
    a, run, params, opt = _setup(microbatches=3)
    with pytest.raises(ValueError, match="microbatches 3"):
        steps.make_train_step(a.cfg, run)(params, opt, _batch(a, 0))


def _run_steps(ts, params, opt, a, lo, hi):
    for step in range(lo, hi):
        params, opt, _ = ts(params, opt, _batch(a, step, seed=9))
    return params, opt


def test_checkpoint_resume_is_exact_replay(tmp_path, one_thread):
    """Steps 0..5 straight against a save after 3, a restore and 3 more:
    bit-equal params (the stateless pipeline and step-indexed batches)."""
    a, run, params, opt = _setup()
    ts = steps.make_train_step(a.cfg, run)
    p_straight, _ = _run_steps(ts, params, opt, a, 0, 6)

    _, _, params, opt = _setup()
    store = CheckpointStore(str(tmp_path))
    p3, o3 = _run_steps(ts, params, opt, a, 0, 3)
    store.save(3, {"params": p3, "opt": o3})
    _, restored, _ = store.restore({"params": p3, "opt": o3})
    assert restored["opt"]["step"].device.type == "cpu"
    p_resumed, o_resumed = _run_steps(ts, restored["params"],
                                      restored["opt"], a, 3, 6)
    assert int(o_resumed["step"]) == 6
    for x, y in zip(tree_leaves(p_straight), tree_leaves(p_resumed)):
        assert torch.equal(x, y)


def test_donated_step_equals_the_functional_step(one_thread):
    a, run, params, opt = _setup()
    kept = [t.clone() for t in tree_leaves(params)]
    batch = _batch(a, 0)
    p_f, o_f, m_f = steps.make_train_step(a.cfg, run)(params, opt, batch)
    for t, k in zip(tree_leaves(params), kept):  # the inputs stay valid
        assert torch.equal(t, k)
    p_d, o_d, m_d = steps.make_train_step(a.cfg, run, donate=True)(
        params, opt, batch)
    assert o_d is opt and int(opt["step"]) == 1
    for x, y in zip(tree_leaves([p_f, o_f]), tree_leaves([p_d, o_d])):
        assert torch.equal(x, y)
    assert all(x is y for x, y in zip(tree_leaves(p_d), tree_leaves(params)))
    assert float(m_f["loss"]) == float(m_d["loss"])


def test_prefill_and_decode_steps_run_whisper():
    """The step functions dispatch an encoder-decoder to
    ``models/whisper.py``: prefill into a cache of 8 rows, then a step."""
    from repro_torch.models import whisper

    a = checks.arch("whisper-large-v3")
    params = a.params()
    batch = checks.fixed_batch(a, 0)
    frames = torch.from_numpy(batch["enc_frames"])
    tok = torch.from_numpy(batch["tokens"][:, :3])
    logits, cache = steps.make_prefill_step(a.cfg)(
        params, enc_frames=frames, tokens=tok, max_len=8)
    want, _ = whisper.prefill(params, a.cfg, frames, tok)
    assert torch.equal(logits, want) and cache["pos"] == 3
    out, cache = steps.make_decode_step(a.cfg)(params, tokens=tok[:, :1],
                                               cache=cache)
    assert tuple(out.shape) == (tok.shape[0], 1, a.cfg.vocab_padded)
    assert cache["pos"] == 4 and not out.requires_grad


def test_prefill_and_decode_steps_are_the_dense_path():
    a = checks.arch("qwen3-1.7b")
    params = a.params()
    tok = torch.from_numpy(checks.fixed_batch(a, 0)["tokens"])
    logits, cache = steps.make_prefill_step(a.cfg)(params, tokens=tok)
    want, _ = transformer.prefill(params, a.cfg, tok)
    assert torch.equal(logits, want) and cache["pos"] == tok.shape[1]
    full = transformer.init_cache(a.cfg, tok.shape[0], 8, "cpu")
    out, full = steps.make_decode_step(a.cfg)(params, tokens=tok[:, :1],
                                              cache=full)
    assert tuple(out.shape) == (tok.shape[0], 1, a.cfg.vocab_padded)
    assert full["pos"] == 1 and not out.requires_grad


def _job(**kw):
    return launch.TrainJob(**{"steps": 6, "batch": 4, "seq": 32,
                              "device": "cpu", "log_every": 1, **kw})


@pytest.mark.parametrize("arch", ["gpt2-124m", "whisper-large-v3"])
def test_train_survives_an_injected_fault(tmp_path, one_thread, arch):
    """A step fault at step 4 (the scenario harness's device-loss signal)
    restarts once from the step-3 checkpoint; the final params equal a run
    without the fault bit for bit, for a decoder LM and for the
    encoder-decoder."""
    clean = launch.train(_job(arch=arch, ckpt_dir=str(tmp_path / "clean"),
                              ckpt_every=3))
    armed = [True]
    marker = tmp_path / "faulted" / "step_00000003" / "_COMMITTED"

    def crash(step):
        # strike once the step-3 checkpoint, written on the store's
        # thread, has committed
        if step == 4 and armed[0]:
            deadline = time.time() + 60
            while not marker.exists() and time.time() < deadline:
                time.sleep(0.01)
            armed[0] = False
            raise SimulatedDeviceLoss("injected device loss at step 4")

    faulted = launch.train(_job(arch=arch,
                                ckpt_dir=str(tmp_path / "faulted"),
                                ckpt_every=3), hook=crash)
    assert clean["restarts"] == 0 and faulted["restarts"] == 1
    # steps 0-3, then the replay from the step-3 checkpoint
    assert [m["step"] for m in faulted["history"]] == [0, 1, 2, 3, 3, 4, 5]
    assert CheckpointStore(str(tmp_path / "faulted")).latest_step() == 6
    for x, y in zip(tree_leaves(clean["state"]["params"]),
                    tree_leaves(faulted["state"]["params"])):
        assert torch.equal(x, y)
    straight = launch.train(_job(arch=arch))
    for x, y in zip(tree_leaves(clean["state"]), tree_leaves(
            straight["state"])):
        assert torch.equal(x, y)
    assert [m["step"] for m in straight["history"]] == list(range(6))
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])
               for m in straight["history"])


def test_train_holds_one_state_at_a_time(tmp_path, monkeypatch):
    """``train`` builds its state once a run, with or without a store; a
    restart builds one more only as the restore's template, which reaches
    the store as shapes alone (meta tensors), so a device never holds the
    job's state twice."""
    built, templates = [], []
    init_state, restore = launch.init_state, CheckpointStore.restore

    def counted(*args):
        built.append(1)
        return init_state(*args)

    def spy(self, template, **kw):
        templates.append({t.device.type for t in tree_leaves(template)})
        return restore(self, template, **kw)

    monkeypatch.setattr(launch, "init_state", counted)
    monkeypatch.setattr(CheckpointStore, "restore", spy)
    launch.train(_job(steps=2))
    launch.train(_job(steps=2, ckpt_dir=str(tmp_path / "clean")))
    assert len(built) == 2 and templates == []
    armed = [True]
    marker = tmp_path / "faulted" / "step_00000001" / "_COMMITTED"

    def crash(step):
        if step == 1 and armed[0]:
            deadline = time.time() + 60
            while not marker.exists() and time.time() < deadline:
                time.sleep(0.01)
            armed[0] = False
            raise SimulatedDeviceLoss("injected device loss at step 1")

    out = launch.train(_job(steps=2, ckpt_every=1,
                            ckpt_dir=str(tmp_path / "faulted")), hook=crash)
    assert out["restarts"] == 1
    assert len(built) == 4 and templates == [{"meta"}]


@pytest.mark.parametrize("arch", ["internvl2-76b", "deepseek-moe-16b",
                                  "whisper-large-v3"])
def test_train_runs_other_archs_with_remat(arch):
    out = launch.train(_job(arch=arch, remat="full", microbatches=2))
    assert out["cfg"].name == checks.arch(arch).cfg.name
    assert all(np.isfinite(m["loss"]) for m in out["history"])


def test_model_axis_above_one_raises():
    """A model axis above one trains on a mesh of ranks
    (``tests/test_torch_train_mesh.py``); one that the train rules cannot
    split, here 3 on the gpt2 smoke config, whose weights it divides none
    of, still raises, before any rank starts."""
    with pytest.raises(MeshShapeError, match="splits none") as e:
        launch.train(_job(model_axis=3))
    assert e.value.shape == (1, 3)
    assert launch.main(["--device", "cpu", "--model-axis", "3"]) == 2


@pytest.mark.parametrize("arch,steps", [("gpt2-124m", 20),
                                        ("whisper-large-v3", 3)])
def test_cli_trains_on_the_cpu(capsys, arch, steps):
    assert launch.main(["--device", "cpu", "--arch", arch, "--smoke",
                        "--steps", str(steps)]) == 0
    assert "done in" in capsys.readouterr().out


def test_cli_runs_on_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert launch.TrainJob().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        launch.main(["--steps", "1"])


def test_example_trains_on_the_cpu(tmp_path, capsys):
    from repro_torch.examples import train_lm

    assert train_lm.main(["--device", "cpu", "--ckpt-dir",
                          str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "(0 restarts" in out and "loss " in out


@pytest.mark.parametrize("real_vocab", [None, 200])
def test_lm_loss_equals_the_reference(real_vocab):
    """Token-mean cross entropy with ignored (-1) labels and a padded vocab
    tail, value and gradient at rtol 1e-5; poisoning the padded tail
    changes nothing (``test_vocab_padding_invisible_to_loss``)."""
    import jax.numpy as jnp

    from repro.models import transformer as ref_tf

    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((2, 8, 256)) * 4).astype(np.float32)
    labels = rng.integers(0, real_vocab or 256, (2, 8)).astype(np.int32)
    labels[0, :3] = -1
    want, want_g = jax.value_and_grad(
        lambda x: ref_tf.lm_loss(x, jnp.asarray(labels),
                                 real_vocab=real_vocab))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = transformer.lm_loss(x, torch.from_numpy(labels),
                              real_vocab=real_vocab)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-8)
    if real_vocab is not None:
        poisoned = torch.from_numpy(logits).clone()
        poisoned[..., real_vocab:] += 100.0
        assert float(transformer.lm_loss(
            poisoned, torch.from_numpy(labels),
            real_vocab=real_vocab)) == float(got)
