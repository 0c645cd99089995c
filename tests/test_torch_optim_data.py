"""The port's AdamW (``optim/adamw.py``) and data pipeline
(``data/pipeline.py``) against the reference's: the unit behaviour of
``tests/test_optim_train.py`` and ``tests/test_data_sharding.py``, then
parity on the same inputs.

Tolerances: the step's learning rate and bias corrections bit-equal to the
reference's jitted arithmetic (the cosine branch's rate within 4 fp32
ulps, in the few steps where XLA's ``cosf`` and the port's rounded double
cosine part);
params, m, v and master after ``apply_update`` at rtol 1e-6, and an atol
of two fp32 ulps of the leaf's largest element (XLA fuses the moment
updates into multiply-adds, one rounding where the port has two, which
moves an element by an ulp: near zero that is no small relative error);
batches bit-equal to the reference's drawn in the same process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
import repro_torch.configs as configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

SMOKE = ShapeConfig("smoke", 16, 4, "train")
STATE_RTOL = 1e-6


# -- AdamW unit behaviour (tests/test_optim_train.py) -------------------------


def test_adamw_converges_on_quadratic():
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                            weight_decay=0.0, grad_clip=1e9)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3)}
    state = adamw.init_opt_state(params, cfg)
    for _ in range(150):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = adamw.apply_update(params, g, state, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=0.05)


def test_grad_clip_caps_update_norm():
    cfg = adamw.AdamWConfig(lr=1e-3, grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = adamw.init_opt_state(params, cfg)
    _, _, stats = adamw.apply_update(params, {"w": torch.full((4,), 1e6)},
                                     state, cfg)
    assert float(stats["grad_norm"]) == pytest.approx(2e6, rel=1e-5)


def test_lr_schedule_shape():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    lrs = [float(adamw.schedule(cfg, torch.tensor(s)))
           for s in range(0, 101, 5)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, rel=0.02)
    assert lrs[-1] == pytest.approx(0.1, rel=0.05)


def test_bf16_state_halves_memory():
    params = {"w": torch.zeros((128, 128), dtype=torch.bfloat16)}
    full = adamw.init_opt_state(params, adamw.AdamWConfig())
    lean = adamw.init_opt_state(params, adamw.AdamWConfig(
        state_dtype="bfloat16", master_weights=False))

    def nbytes(state):
        return sum(t.numel() * t.element_size()
                   for t in adamw.tree_leaves(state))

    assert nbytes(lean) < 0.35 * nbytes(full)


def test_master_weights_carry_precision():
    """bf16 params + fp32 master accumulate tiny updates that bf16 alone
    loses."""
    cfg = adamw.AdamWConfig(lr=1e-4, warmup_steps=0, weight_decay=0.0)
    params = {"w": torch.ones(8, dtype=torch.bfloat16)}
    state = adamw.init_opt_state(params, cfg)
    g = {"w": torch.full((8,), 1e-3, dtype=torch.bfloat16)}
    for _ in range(3):
        params, state, _ = adamw.apply_update(params, g, state, cfg)
    master = state["master"]["w"].numpy()
    assert np.all(master < 1.0)
    assert not np.allclose(master, params["w"].float().numpy())


def test_master_is_a_copy_and_the_step_lives_on_the_host():
    params = {"w": torch.ones(4)}
    state = adamw.init_opt_state(params, adamw.AdamWConfig())
    assert state["master"]["w"].data_ptr() != params["w"].data_ptr()
    assert state["step"].device.type == "cpu"
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0


# -- parity with the reference's arithmetic -----------------------------------

SCHEDULES = [adamw.AdamWConfig(),
             adamw.AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=1000),
             adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)]


def _ref_scalars(cfg, steps):
    rcfg = ref_adamw.AdamWConfig(**cfg.__dict__)

    def scalars(step):
        s = step.astype(jnp.float32)
        return (ref_adamw.schedule(rcfg, step), 1 - rcfg.b1 ** s,
                1 - rcfg.b2 ** s)

    out = jax.vmap(jax.jit(scalars))(jnp.asarray(steps, jnp.int32))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("cfg", SCHEDULES, ids=["default", "no-warmup",
                                                 "short"])
def test_step_scalars_equal_the_reference(cfg):
    steps = np.arange(0, cfg.total_steps + 20, 3)
    lr_ref, bc1_ref, bc2_ref = _ref_scalars(cfg, steps)
    lr = np.array([float(adamw.schedule(cfg, torch.tensor(int(s))))
                   for s in steps], np.float32)
    bcs = np.array([[float(b) for b in adamw.bias_corrections(
        cfg, torch.tensor(int(s)))] for s in steps], np.float32)
    np.testing.assert_array_equal(bcs[:, 0], bc1_ref)
    np.testing.assert_array_equal(bcs[:, 1], bc2_ref)
    warm = steps < cfg.warmup_steps
    np.testing.assert_array_equal(lr[warm], lr_ref[warm])
    # the cosine branch: XLA's cosf and the port's rounded double cosine
    # part by an ulp of the cosine in about one step of 75, which the
    # fused multiply-add carries into at most 4 ulps of the floor rate
    np.testing.assert_array_max_ulp(lr[~warm], lr_ref[~warm], maxulp=4)
    assert np.sum(lr[~warm] != lr_ref[~warm]) <= max(2, steps.size // 25)


def _tree(seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((8, 16)).astype(dtype),
                  "b": rng.standard_normal((16,)).astype(dtype)},
            "c": rng.standard_normal((5, 3, 2)).astype(dtype)}


@pytest.mark.parametrize("cfg", [
    adamw.AdamWConfig(),
    adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6,
                      grad_clip=0.5),
    adamw.AdamWConfig(master_weights=False, weight_decay=0.0),
], ids=["default", "clipped-cosine", "no-master"])
@pytest.mark.parametrize("inplace", [False, True])
def test_apply_update_equals_the_reference(cfg, inplace):
    """Five steps of the reference's jitted ``apply_update`` and the
    port's on the same tree: lr bit-equal, state at rtol 1e-6."""
    rcfg = ref_adamw.AdamWConfig(**cfg.__dict__)
    rp = jax.tree.map(jnp.asarray, _tree(0))
    rs = ref_adamw.init_opt_state(rp, rcfg)
    upd = jax.jit(lambda p, g, s: ref_adamw.apply_update(p, g, s, rcfg))
    params = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), _tree(0))
    state = adamw.init_opt_state(params, cfg)
    for step in range(5):
        grads = _tree(10 + step)
        rp, rs, rstats = upd(rp, jax.tree.map(jnp.asarray, grads), rs)
        before = params
        params, state, stats = adamw.apply_update(
            params, jax.tree.map(torch.from_numpy, grads), state, cfg,
            inplace=inplace)
        assert (params["c"] is before["c"]) == inplace
        assert float(stats["lr"]) == float(rstats["lr"])
        np.testing.assert_allclose(float(stats["grad_norm"]),
                                   float(rstats["grad_norm"]), rtol=1e-6)
    assert int(state["step"]) == int(rs["step"]) == 5
    pairs = [(params, rp), (state["m"], rs["m"]), (state["v"], rs["v"])]
    if cfg.master_weights:
        pairs.append((state["master"], rs["master"]))
    for got, want in pairs:
        for g, w in zip(adamw.tree_leaves(got), jax.tree.leaves(want)):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=STATE_RTOL,
                                       atol=2 ** -22 * np.abs(w).max())


def test_functional_update_leaves_its_inputs():
    cfg = adamw.AdamWConfig(warmup_steps=0)
    params = {"w": torch.ones(4)}
    state = adamw.init_opt_state(params, cfg)
    new_p, new_s, _ = adamw.apply_update(params, {"w": torch.ones(4)}, state,
                                         cfg)
    assert torch.equal(params["w"], torch.ones(4))
    assert int(state["step"]) == 0 and not state["m"]["w"].any()
    assert int(new_s["step"]) == 1 and not torch.equal(new_p["w"],
                                                       params["w"])


# -- the data pipeline (tests/test_data_sharding.py) --------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 17), (100, 10_000)])
def test_batch_is_pure_function_of_seed_and_step(seed, step):
    cfg = configs.get_smoke_config("qwen3-1.7b")
    dc = pipeline.DataConfig(seed=seed)
    b1 = pipeline.global_batch(cfg, SMOKE, dc, step)
    b2 = pipeline.global_batch(cfg, SMOKE, dc, step)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    np.testing.assert_array_equal(b1["labels"], b2["labels"])


def test_different_steps_differ():
    cfg = configs.get_smoke_config("qwen3-1.7b")
    dc = pipeline.DataConfig(seed=0)
    b1 = pipeline.global_batch(cfg, SMOKE, dc, 0)
    b2 = pipeline.global_batch(cfg, SMOKE, dc, 1)
    assert not np.array_equal(b1["tokens"], b2["tokens"])


def test_tokens_in_vocab_and_labels_shifted():
    cfg = configs.get_smoke_config("qwen3-1.7b")
    b = pipeline.global_batch(cfg, SMOKE, pipeline.DataConfig(), 3)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < cfg.vocab
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_host_slices_tile_the_global_batch(nproc):
    cfg = configs.get_smoke_config("qwen3-1.7b")
    dc = pipeline.DataConfig(seed=1)
    full = pipeline.global_batch(cfg, SMOKE, dc, 5)
    parts = []
    for p in range(nproc):
        sl = pipeline.host_slice_for(p, nproc, SMOKE.global_batch)
        parts.append(pipeline.global_batch(cfg, SMOKE, dc, 5,
                                           host_slice=sl)["tokens"])
    np.testing.assert_array_equal(np.concatenate(parts, 0), full["tokens"])


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-large-v3"])
def test_modality_stubs_match_input_specs(arch):
    """The VLM's image embeddings and the encoder-decoder's post-conv
    frames (max(S // 4, 8) of them, beside S tokens) have the shapes and
    dtypes of the reference's ``input_specs``."""
    cfg = configs.get_smoke_config(arch)
    b = pipeline.global_batch(cfg, SMOKE, pipeline.DataConfig(), 0)
    specs = ref_configs.input_specs(ref_configs.get_smoke_config(arch),
                                    RefShape("smoke", 16, 4, "train"))
    assert set(b) == set(specs)
    for k in b:
        assert tuple(b[k].shape) == tuple(specs[k].shape), k
        assert b[k].dtype == np.dtype(specs[k].dtype), k


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-76b",
                                  "whisper-large-v3"])
@pytest.mark.parametrize("sliced", [False, True])
def test_batches_equal_the_reference_in_one_process(arch, sliced):
    """The reference's ``hash(role)`` seeds are per process; in one
    process both pipelines draw the same batches."""
    cfg = configs.get_smoke_config(arch)
    rcfg = ref_configs.get_smoke_config(arch)
    rshape = RefShape("smoke", 16, 4, "train")
    sl = pipeline.host_slice_for(1, 2, 4) if sliced else None
    for seed, step in ((0, 0), (7, 123)):
        got = pipeline.global_batch(cfg, SMOKE, pipeline.DataConfig(seed=seed),
                                    step, host_slice=sl)
        want = ref_pipeline.global_batch(
            rcfg, rshape, ref_pipeline.DataConfig(seed=seed), step,
            host_slice=sl)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
