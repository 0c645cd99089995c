"""The port's whisper (``models/whisper.py``) against
``repro.models.whisper`` on the reference's weights (``init_whisper`` of
the JAX package, carried across by ``whisper.params_from_numpy``), on the
smoke config in f32: the configs, the converter, ``encode`` and
``forward``, ``prefill`` and its caches, ``decode_step`` at several
positions against the reference's ``forward``, one decode step after the
reference's own ``prefill``, the step functions, the no-room error, and
the flash backward of a cross-attention (Sq != Sk, no mask) that the
decoder's gradients run through.

Inputs are made from a seed with numpy.  Tolerances: logits and caches
rtol 1e-4 and atol 1e-5 (the cell bound of the dense path's tests); the
flash gradients rtol 1e-4 and atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.models import flash as ref_flash  # noqa: E402
from repro.models import whisper as ref_whisper  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.models import flash, whisper  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.train import steps  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

ARCH = "whisper-large-v3"
TOL = dict(rtol=1e-4, atol=1e-5)
#: the smoke shapes: 2 slots, 8 encoder frames, 12 decoder tokens
B, SE, SD = 2, 8, 12


@functools.lru_cache(maxsize=None)
def _model():
    rcfg = ref_configs.get_smoke_config(ARCH)
    cfg = port_configs.get_smoke_config(ARCH)
    rp = ref_whisper.init_whisper(jax.random.PRNGKey(0), rcfg)
    return rcfg, cfg, rp, jax.tree.map(np.asarray, rp)


def _params():
    _, cfg, _, tree = _model()
    return whisper.params_from_numpy(tree, cfg, "cpu")


def _inputs(seed=0, b=B, se=SE, sd=SD):
    cfg = _model()[1]
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, se, cfg.d_model), dtype=np.float32)
    tokens = rng.integers(0, cfg.vocab, (b, sd)).astype(np.int32)
    return frames, tokens


@functools.lru_cache(maxsize=None)
def _ref_forward(seed=0):
    rcfg, _, rp, _ = _model()
    frames, tokens = _inputs(seed)
    logits, aux = jax.jit(lambda p, f, t: ref_whisper.forward(p, rcfg, f, t))(
        rp, frames, tokens)
    return np.asarray(logits), float(aux)


def _t(a):
    return torch.from_numpy(np.array(a))


# -- configs and parameters ---------------------------------------------------


@pytest.mark.parametrize("size", ["full", "smoke"])
def test_configs_equal_the_reference(size):
    import dataclasses

    get = "get_config" if size == "full" else "get_smoke_config"
    port, ref = (getattr(m, get)(ARCH) for m in (port_configs, ref_configs))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count()
    assert port.is_encoder_decoder and whisper.n_dec_layers(port) == \
        port.n_layers - port.enc_layers
    if size == "full":
        assert (port.enc_layers, whisper.n_dec_layers(port)) == (32, 32)
        assert port.vocab_padded == 51968


def test_converter_round_trip():
    """Row i of every stacked leaf is layer i's leaf, bit for bit, and
    the port's tree has the reference's leaf count and sizes."""
    _, cfg, _, tree = _model()
    params = _params()
    assert len(params["enc_layers"]) == cfg.enc_layers
    assert len(params["dec_layers"]) == whisper.n_dec_layers(cfg)
    for stack, key in (("enc_blocks", "enc_layers"),
                       ("dec_blocks", "dec_layers")):
        flat = jax.tree_util.tree_flatten_with_path(tree[stack])[0]
        for i, layer in enumerate(params[key]):
            for path, leaf in flat:
                got = layer
                for k in path:
                    got = got[k.key]
                np.testing.assert_array_equal(got.numpy(), leaf[i])
    for key in ("embed", "enc_norm", "final_norm", "lm_head"):
        for g, w in zip(tree_leaves(params[key]), jax.tree.leaves(tree[key])):
            np.testing.assert_array_equal(g.numpy(), w)
    assert sum(p.numel() for p in tree_leaves(params)) == \
        sum(x.size for x in jax.tree.leaves(tree))
    with pytest.raises(ValueError, match="not a parameter tree"):
        whisper.params_from_numpy({"embed": tree["embed"]}, cfg, "cpu")


def test_init_lays_out_the_reference_tree():
    """The port's seeded init has the converted tree's structure, shapes
    and dtypes, is a function of the seed, and differs between seeds."""
    _, cfg, _, _ = _model()
    ours = whisper.init_whisper(cfg, seed=0, device="cpu")
    theirs = _params()
    a, b = tree_leaves(ours), tree_leaves(theirs)
    assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype) for t in b]
    again = tree_leaves(whisper.init_whisper(cfg, seed=0, device="cpu"))
    other = tree_leaves(whisper.init_whisper(cfg, seed=1, device="cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, again))
    assert not all(torch.equal(x, y) for x, y in zip(a, other))
    assert steps.init_model(cfg, seed=0, device="cpu").keys() == ours.keys()


# -- the train path -----------------------------------------------------------


def test_encode_matches_the_reference():
    rcfg, cfg, rp, _ = _model()
    frames, _ = _inputs()
    want = jax.jit(lambda p, f: ref_whisper.encode(p, rcfg, f))(rp, frames)
    got = whisper.encode(_params(), cfg, _t(frames))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, SE,
                                                               cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_forward_matches_the_reference(remat):
    _, cfg, _, _ = _model()
    frames, tokens = _inputs()
    want, want_aux = _ref_forward()
    logits, aux = whisper.forward(_params(), cfg, _t(frames), _t(tokens),
                                  remat=remat)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, SD, cfg.vocab_padded)
    np.testing.assert_allclose(logits.detach().numpy(), want, **TOL)
    assert float(aux) == want_aux == 0.0


def test_unknown_remat_policy_raises():
    _, cfg, _, _ = _model()
    frames, tokens = _inputs()
    with pytest.raises(ValueError, match="remat"):
        whisper.forward(_params(), cfg, _t(frames), _t(tokens),
                        remat="offload")


def test_decoder_only_configs_are_refused():
    cfg = port_configs.get_smoke_config("gpt2-124m")
    with pytest.raises(ValueError, match="encoder-decoder"):
        whisper.init_whisper(cfg, device="cpu")


@pytest.mark.parametrize("Sq,Sk,chunks", [(20, 12, (8, 8)), (9, 24, (4, 16)),
                                          (16, 6, (16, 16))])
def test_flash_backward_of_a_cross_attention(Sq, Sk, chunks):
    """``_Flash``'s dq, dk and dv for Sq != Sk without a causal mask, with
    padded q and k tiles: the decoder's queries over the encoder's rows."""
    rng = np.random.default_rng(Sq * Sk)
    q = rng.standard_normal((2, Sq, 2, 2, 16)).astype(np.float32)
    k = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, Sk, 2, 16)).astype(np.float32)
    do = rng.standard_normal((2, Sq, 2, 2, 16)).astype(np.float32)
    qc, kc = chunks

    def loss(q, k, v):
        out = ref_flash.flash_attention(q, k, v, causal=False, q_chunk=qc,
                                        k_chunk=kc)
        return jnp.sum(out * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(q, k, v)
    live = [_t(a).requires_grad_() for a in (q, k, v)]
    out = flash.flash_attention(*live, causal=False, q_chunk=qc, k_chunk=kc)
    (out * _t(do)).sum().backward()
    for name, t, w in zip("qkv", live, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   err_msg=f"d{name}", **TOL)


# -- prefill and decode -------------------------------------------------------


@pytest.mark.parametrize("max_len", [None, 16])
def test_prefill_matches_the_reference(max_len):
    """The last token's logits and every cache leaf; with ``max_len`` the
    prompt's rows come first in a cache of ``max_len`` rows, zeros after
    them."""
    rcfg, cfg, rp, _ = _model()
    frames, tokens = _inputs()
    sd = 5
    rlogits, rcache = jax.jit(
        lambda p, f, t: ref_whisper.prefill(p, rcfg, f, t))(
        rp, frames, tokens[:, :sd])
    logits, cache = steps.make_prefill_step(cfg)(
        _params(), enc_frames=_t(frames), tokens=_t(tokens[:, :sd]),
        max_len=max_len)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    assert cache["pos"] == int(rcache["pos"]) == sd
    assert cache["k"].shape[2] == (sd if max_len is None else max_len)
    for key in ("k", "v", "cross_k", "cross_v"):
        want = np.asarray(rcache[key])
        got = cache[key].numpy()
        np.testing.assert_allclose(got[:, :, :want.shape[2]], want,
                                   err_msg=key, **TOL)
        assert not got[:, :, want.shape[2]:].any(), key


def test_prefill_refuses_a_cache_shorter_than_the_prompt():
    _, cfg, _, _ = _model()
    frames, tokens = _inputs()
    with pytest.raises(ValueError, match="max_len"):
        whisper.prefill(_params(), cfg, _t(frames), _t(tokens), max_len=4)


@pytest.mark.parametrize("prompt", [1, 4])
def test_decode_steps_match_the_reference_forward(prompt):
    """Prefill ``prompt`` tokens into a cache of 16 rows, then decode the
    rest one token a step: each step's logits are the reference's
    teacher-forced logits at that position."""
    _, cfg, _, _ = _model()
    frames, tokens = _inputs()
    want, _ = _ref_forward()
    params = _params()
    logits, cache = steps.make_prefill_step(cfg)(
        params, enc_frames=_t(frames), tokens=_t(tokens[:, :prompt]),
        max_len=16)
    np.testing.assert_allclose(logits[:, 0].numpy(), want[:, prompt - 1],
                               **TOL)
    decode = steps.make_decode_step(cfg)
    for t in range(prompt, SD):
        logits, cache = decode(params, tokens=_t(tokens[:, t:t + 1]),
                               cache=cache)
        assert cache["pos"] == t + 1 and not logits.requires_grad
        np.testing.assert_allclose(logits[:, 0].numpy(), want[:, t],
                                   err_msg=f"position {t}", **TOL)


def test_decode_from_an_empty_cache_matches_the_reference_forward():
    """Every token through ``decode_step`` from :func:`init_dec_cache`,
    whose cross K/V the caller fills from a prefill."""
    _, cfg, _, _ = _model()
    frames, tokens = _inputs()
    want, _ = _ref_forward()
    params = _params()
    _, pre = whisper.prefill(params, cfg, _t(frames), _t(tokens[:, :1]))
    cache = whisper.init_dec_cache(cfg, B, SD, SE, "cpu")
    assert cache["pos"] == 0 and cache["k"].shape == (
        whisper.n_dec_layers(cfg), B, SD, cfg.n_kv_heads, cfg.head_dim)
    cache["cross_k"].copy_(pre["cross_k"])
    cache["cross_v"].copy_(pre["cross_v"])
    for t in range(SD):
        logits, cache = whisper.decode_step(params, cfg,
                                            _t(tokens[:, t:t + 1]), cache)
        np.testing.assert_allclose(logits[:, 0].numpy(), want[:, t], **TOL)


def test_one_step_after_the_references_own_prefill():
    """The reference's prefill cache holds exactly the prompt's rows; its
    next decode step's logits (taken before its clamped commit) equal the
    port's step after a prefill into a longer cache."""
    rcfg, cfg, rp, _ = _model()
    frames, tokens = _inputs(seed=3)
    sd = 6
    rlogits, rcache = jax.jit(
        lambda p, f, t: ref_whisper.prefill(p, rcfg, f, t))(
        rp, frames, tokens[:, :sd])
    rstep, _ = jax.jit(lambda p, t, c: ref_whisper.decode_step(
        p, rcfg, t, c))(rp, tokens[:, sd:sd + 1], rcache)
    params = _params()
    _, cache = whisper.prefill(params, cfg, _t(frames), _t(tokens[:, :sd]),
                               max_len=sd + 1)
    logits, cache = whisper.decode_step(params, cfg,
                                        _t(tokens[:, sd:sd + 1]), cache)
    np.testing.assert_allclose(logits.numpy(), np.asarray(rstep), **TOL)
    assert cache["pos"] == sd + 1


def test_decode_step_without_room_raises():
    _, cfg, _, _ = _model()
    frames, tokens = _inputs()
    params = _params()
    _, cache = whisper.prefill(params, cfg, _t(frames), _t(tokens[:, :4]))
    with pytest.raises(ValueError, match="no room"):
        whisper.decode_step(params, cfg, _t(tokens[:, 4:5]), cache)
    assert cache["pos"] == 4


def test_cross_decode_is_the_dense_decode_kernel_function():
    """One token's cross-attention equals the prefill path's flash
    attention over the same K/V (the reference's direct softmax)."""
    _, cfg, _, _ = _model()
    p = _params()["dec_layers"][0]["xattn"]
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32))
    enc = _t(rng.standard_normal((3, 40, cfg.d_model), dtype=np.float32))
    k, v = whisper._cross_kv(p, cfg, enc)
    enc_len = torch.full((3,), 40, dtype=torch.int32)
    got = whisper.cross_decode(p, cfg, x, k, v, enc_len)
    want = whisper._cross_attend(p, cfg, x, k, v)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), **TOL)
