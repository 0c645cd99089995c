"""Per-function parity of ``repro_torch.models.layers`` (and the attention
projection) with ``repro.models.layers``.

Inputs are drawn with numpy from a fixed seed and handed to both.  The
tolerance is fp32's: the two frameworks order their sums differently, so
results agree to a few ulps, not bitwise (rtol 1e-5, atol 1e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.models import attention as ref_attention  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.models import attention, layers, transformer  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("bias", [False, True])
def test_dense(bias):
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 3, 5, 16), _rand(rng, 16, 24), _rand(rng, 24)
    p_ref = {"w": jnp.asarray(w)}
    p = {"w": _t(w)}
    if bias:
        p_ref["b"], p["b"] = jnp.asarray(b), _t(b)
    _close(layers.dense(p, _t(x)), ref_layers.dense(p_ref, jnp.asarray(x)))


@pytest.mark.parametrize("with_scale", [False, True])
def test_rms_norm(with_scale):
    rng = np.random.default_rng(1)
    x, s = _rand(rng, 4, 7, 32), _rand(rng, 32)
    p_ref = {"scale": jnp.asarray(s)} if with_scale else None
    p = {"scale": _t(s)} if with_scale else None
    _close(layers.rms_norm(p, _t(x), 1e-5),
           ref_layers.rms_norm(p_ref, jnp.asarray(x), 1e-5))


@pytest.mark.parametrize("parametric", [False, True])
def test_layer_norm(parametric):
    rng = np.random.default_rng(2)
    x = _rand(rng, 4, 7, 32) * 3.0 + 1.0
    s, b = _rand(rng, 32), _rand(rng, 32)
    p_ref = {"scale": jnp.asarray(s), "bias": jnp.asarray(b)} \
        if parametric else {}
    p = {"scale": _t(s), "bias": _t(b)} if parametric else {}
    _close(layers.layer_norm(p, _t(x)),
           ref_layers.layer_norm(p_ref, jnp.asarray(x)))


def test_norms_cast_back_to_input_dtype():
    x = torch.randn(2, 8, generator=torch.Generator().manual_seed(0))
    xb = x.to(torch.bfloat16)
    assert layers.rms_norm(None, xb).dtype == torch.bfloat16
    assert layers.layer_norm({}, xb).dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["gpt2-124m", "qwen3-1.7b"])
def test_make_norm(arch):
    cfg = port_configs.get_smoke_config(arch)
    rcfg = ref_configs.get_smoke_config(arch)
    init, apply = layers.make_norm(cfg)
    r_init, r_apply = ref_layers.make_norm(rcfg)
    p = init(torch.float32, "cpu")
    p_ref = r_init(jnp.float32)
    assert set(p) == set(p_ref)
    x = _rand(np.random.default_rng(3), 2, 3, cfg.d_model)
    _close(apply(p, _t(x)), r_apply(p_ref, jnp.asarray(x)))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_cos_sin(theta):
    pos = np.array([[0, 3, 17], [5, 100, 2047]], np.int32)
    cos, sin = layers.rope_cos_sin(_t(pos), 16, theta)
    r_cos, r_sin = ref_layers.rope_cos_sin(jnp.asarray(pos), 16, theta)
    _close(cos, r_cos)
    _close(sin, r_sin)


@pytest.mark.parametrize("per_slot", [False, True])
def test_apply_rope_split_half(per_slot):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 3, 4, 16)
    cos, sin = _rand(rng, 2, 3, 8), _rand(rng, 2, 3, 8)
    if not per_slot:
        cos, sin = cos[0], sin[0]
    _close(layers.apply_rope(_t(x), _t(cos), _t(sin)),
           ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(cos),
                                 jnp.asarray(sin)))


def test_swiglu():
    rng = np.random.default_rng(5)
    x = _rand(rng, 2, 3, 16)
    w = {"wi_gate": _rand(rng, 16, 40), "wi_up": _rand(rng, 16, 40),
         "wo": _rand(rng, 40, 16)}
    _close(layers.swiglu({k: _t(v) for k, v in w.items()}, _t(x)),
           ref_layers.swiglu({k: jnp.asarray(v) for k, v in w.items()},
                             jnp.asarray(x)))


def test_embed_and_unembed():
    rng = np.random.default_rng(6)
    table = _rand(rng, 50, 16)
    tokens = rng.integers(0, 50, size=(3, 4)).astype(np.int32)
    x = _rand(rng, 3, 4, 16)
    p, p_ref = {"embedding": _t(table)}, {"embedding": jnp.asarray(table)}
    _close(layers.embed(p, _t(tokens)),
           ref_layers.embed(p_ref, jnp.asarray(tokens)))
    logits = layers.unembed(p, _t(x))
    assert logits.dtype == torch.float32
    _close(logits, ref_layers.unembed(p_ref, jnp.asarray(x)))


def test_unembed_runs_in_compute_dtype():
    """The matmul runs in x's dtype before the cast to fp32, so a bf16
    model's logits carry bf16 rounding, as in the reference."""
    rng = np.random.default_rng(7)
    table, x = _rand(rng, 50, 16), _rand(rng, 2, 16)
    p = {"embedding": _t(table).to(torch.bfloat16)}
    got = layers.unembed(p, _t(x).to(torch.bfloat16))
    want = (_t(x).to(torch.bfloat16) @ p["embedding"].T).float()
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("arch", ["gpt2-124m", "qwen3-1.7b"])
def test_project_qkv(arch):
    """q/k/v of layer 0 with the reference's weights, at per-slot
    positions (qk-norm and RoPE included)."""
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = port_configs.get_smoke_config(arch)
    tree = jax.tree.map(np.asarray,
                        ref_steps.init_model(jax.random.PRNGKey(0), rcfg))
    params = transformer.params_from_numpy(tree, cfg, "cpu")
    rng = np.random.default_rng(8)
    x = _rand(rng, 3, 1, cfg.d_model)
    pos = np.array([[0], [7], [30]], np.int32)
    ref_p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         tree["blocks"]["slot0"]["attn"])
    want = ref_attention._project_qkv(ref_p, rcfg, jnp.asarray(x),
                                      jnp.asarray(pos))
    got = attention._project_qkv(params["layers"][0]["attn"], cfg, _t(x),
                                 _t(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_params_from_numpy_round_trips_bf16_leaves():
    """bf16 JAX leaves (ml_dtypes arrays, read-only) widen exactly and land
    in the config's dtype, one dict per layer."""
    cut = dict(n_layers=2, d_model=64, n_heads=1, n_kv_heads=1, d_ff=64,
               vocab=256)
    rcfg = dataclasses.replace(ref_configs.get_config("gpt2-124m"), **cut)
    cfg = dataclasses.replace(port_configs.get_config("gpt2-124m"), **cut)
    tree = jax.tree.map(np.asarray,
                        ref_steps.init_model(jax.random.PRNGKey(1), rcfg))
    assert tree["embed"]["embedding"].dtype.name == "bfloat16"
    params = transformer.params_from_numpy(tree, cfg, "cpu")
    assert len(params["layers"]) == 2
    emb = params["embed"]["embedding"]
    assert emb.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        emb.float().numpy(),
        tree["embed"]["embedding"].astype(np.float32))
    wq = params["layers"][1]["attn"]["wq"]["w"]
    np.testing.assert_array_equal(
        wq.float().numpy(),
        tree["blocks"]["slot0"]["attn"]["wq"]["w"][1].astype(np.float32))
