"""The port's Mamba-2 mixer against the JAX package's.

Inputs are made from a seed with numpy and the reference's parameters
(``repro.models.ssm.init_mamba``) are carried across leaf by leaf:

* ``mamba_decode``: output and both states, f32, at rtol 1e-5 and atol
  1e-5, over several steps from a nonzero state;
* ``mamba_full``: against the reference's, with and without
  ``initial_state``, at the reference's bound for the dual form against
  the recurrence (rtol 2e-4, atol 2e-4, ``tests/test_ssm.py``);
* ``mamba_chunk``, the serve path's chunk form: on ``(B, w, d)`` with
  ragged lengths (0, 1, some, w) against the reference's ``mamba_decode``
  scanned row by row, at rtol 2e-4 and atol 2e-4; rows past a slot's
  length leave both states and the live rows' outputs bit-equal whatever
  they hold;
* the port's mirror of ``tests/test_ssm.py`` and
  ``test_mamba_state_is_fp32``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.models import layers, ssm, transformer  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
TIGHT = dict(rtol=1e-5, atol=1e-5)
DUAL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(chunk=8, d_model=32, d_state=8, head_dim=8, n_groups=1):
    """The reference's and the port's mamba2 smoke config, narrowed as
    ``tests/test_ssm.py`` narrows it."""
    out = []
    for configs in (ref_configs, port_configs):
        base = configs.get_smoke_config("mamba2-370m")
        out.append(dataclasses.replace(
            base, d_model=d_model, ssm=dataclasses.replace(
                base.ssm, chunk=chunk, d_state=d_state, head_dim=head_dim,
                n_groups=n_groups)))
    return out


def _params(rcfg, seed=0, dtype=jnp.float32):
    """The reference's mixer parameters, and the same numbers as the
    port's (``A_log``, ``D`` and ``dt_bias`` fp32, as the reference keeps
    them).  ``A_log`` and ``dt_bias`` are drawn away from their zero init
    so that the decays and step sizes differ by head."""
    rp = ref_ssm.init_mamba(jax.random.PRNGKey(seed), rcfg, dtype)
    rng = np.random.default_rng(seed)
    nh = rcfg.ssm.n_heads(rcfg.d_model)
    rp["A_log"] = jnp.asarray(rng.uniform(-1.0, 1.0, nh), jnp.float32)
    rp["dt_bias"] = jnp.asarray(rng.uniform(-2.0, 0.5, nh), jnp.float32)

    def leaf(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t if a.dtype == jnp.float32 else t.to(torch.bfloat16)

    return rp, transformer._map_tree(rp, leaf)


def _x(shape, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _state(rcfg, B, seed):
    s = rcfg.ssm
    nh = s.n_heads(rcfg.d_model)
    conv_ch = s.d_inner(rcfg.d_model) + 2 * s.n_groups * s.d_state
    return (_x((B, nh, s.d_state, s.head_dim), seed, 0.3),
            _x((B, s.d_conv - 1, conv_ch), seed + 1))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_init_mamba_has_the_reference_leaves():
    rcfg, cfg = _cfgs()
    rp = jax.eval_shape(lambda: ref_ssm.init_mamba(jax.random.PRNGKey(0),
                                                   rcfg, jnp.bfloat16))
    own = ssm.init_mamba(torch.Generator().manual_seed(0), cfg,
                         torch.bfloat16, "cpu")
    want = jax.tree_util.tree_flatten_with_path(rp)[0]
    got = transformer._map_tree(own, lambda t: t)
    for path, leaf in want:
        node = got
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert str(node.dtype).split(".")[1] == str(leaf.dtype), path


def test_init_mamba_draws_are_seeded_and_fan_in_scaled():
    _, cfg = _cfgs(d_model=64)
    a = ssm.init_mamba(torch.Generator().manual_seed(3), cfg, torch.float32,
                       "cpu")
    b = ssm.init_mamba(torch.Generator().manual_seed(3), cfg, torch.float32,
                       "cpu")
    assert all(torch.equal(a[k]["w"], b[k]["w"])
               for k in ("wz", "wx", "wBC", "wdt", "out_proj"))
    assert not torch.equal(a["wz"]["w"], a["wx"]["w"])
    w = a["wx"]["w"]
    assert float(w.abs().max()) <= 2.0 / 64 ** 0.5 + 1e-6
    assert abs(float(w.std()) * 8.0 - 0.96) < 0.03  # clipped at 2 std


def test_truncated_normal_many_does_not_depend_on_threads(monkeypatch):
    shapes = ((16, 8), (4, 32), (8, 8))
    a = layers.truncated_normal_many(torch.Generator().manual_seed(1),
                                     shapes, 1.0, torch.float32, "cpu")
    monkeypatch.setattr(layers.os, "cpu_count", lambda: 1)
    b = layers.truncated_normal_many(torch.Generator().manual_seed(1),
                                     shapes, 1.0, torch.float32, "cpu")
    assert [tuple(t.shape) for t in a] == list(shapes)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_a_draw_is_the_clipped_scaled_stream_of_its_generator():
    """On a CPU generator a draw is the generator's fp32 normal stream,
    clipped at two standard deviations and scaled by the fan-in, then
    cast: the port's seeded numbers, the same on every device they are
    moved to; ``init_lm``'s default ``draw_device`` is that CPU
    stream."""
    got = layers.truncated_normal(torch.Generator().manual_seed(4),
                                  (25, 40), 1.0, torch.bfloat16, "cpu")
    want = torch.randn((25, 40), generator=torch.Generator().manual_seed(4))
    assert torch.equal(got, (want.clamp(-2.0, 2.0) * 0.2).to(torch.bfloat16))
    _, cfg = _cfgs(d_model=64)
    a = transformer.init_lm(cfg, seed=3, device="cpu")
    b = transformer.init_lm(cfg, seed=3, device="cpu", draw_device="cpu")

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for v in tree.values() for x in leaves(v)]
        if isinstance(tree, list):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    assert len(leaves(a)) > 10
    assert all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_softplus_follows_jax_past_torchs_threshold():
    x = np.array([-30.0, -1.0, 0.0, 19.5, 20.5, 40.0], np.float32)
    np.testing.assert_allclose(ssm._softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-7,
                               atol=0)


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba_decode_matches_reference(n_groups):
    rcfg, cfg = _cfgs(n_groups=n_groups)
    rp, params = _params(rcfg)
    s0, c0 = _state(rcfg, 3, seed=4)
    rs, rc, ps, pc = s0, c0, _t(s0), _t(c0)
    for step in range(4):
        x = _x((3, 1, rcfg.d_model), seed=10 + step)
        want, rs, rc = ref_ssm.mamba_decode(rp, rcfg, x, rs, rc)
        got, ps, pc = ssm.mamba_decode(params, cfg, _t(x), ps, pc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
        np.testing.assert_allclose(ps.numpy(), np.asarray(rs), **TIGHT)
        np.testing.assert_allclose(pc.numpy(), np.asarray(rc), **TIGHT)
    assert ps.dtype == torch.float32


@pytest.mark.parametrize("S,chunk", [(16, 8), (13, 8), (7, 4), (24, 16)])
@pytest.mark.parametrize("initial", [False, True], ids=["zero", "state"])
def test_mamba_full_matches_reference(S, chunk, initial):
    rcfg, cfg = _cfgs(chunk=chunk)
    rp, params = _params(rcfg)
    x = _x((2, S, rcfg.d_model), seed=1)
    s0 = _state(rcfg, 2, seed=2)[0] if initial else None
    want, ws = ref_ssm.mamba_full(rp, rcfg, x, initial_state=s0,
                                  return_state=True)
    got, gs = ssm.mamba_full(params, cfg, _t(x), return_state=True,
                             initial_state=None if s0 is None else _t(s0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DUAL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **DUAL)
    plain = ssm.mamba_full(params, cfg, _t(x),
                           initial_state=None if s0 is None else _t(s0))
    assert torch.equal(plain, got)


#: (w, lengths): a slot fed nothing, one row, some rows and the whole chunk
RAGGED = [(8, [0, 1, 5, 8]), (16, [16, 3, 0, 11]), (1, [1, 0, 1, 1])]


def _scanned(rp, rcfg, x, s0, c0, lengths):
    """The reference's one-token cell scanned over each slot's real rows:
    outputs of those rows and the states after them."""
    ys, ss, cs = [], [], []
    for b, n in enumerate(lengths):
        s, c = s0[b:b + 1], c0[b:b + 1]
        rows = []
        for t in range(n):
            y, s, c = ref_ssm.mamba_decode(rp, rcfg, x[b:b + 1, t:t + 1],
                                           s, c)
            rows.append(np.asarray(y)[0, 0])
        ys.append(rows)
        ss.append(np.asarray(s)[0])
        cs.append(np.asarray(c)[0])
    return ys, np.stack(ss), np.stack(cs)


@pytest.mark.parametrize("w,lengths", RAGGED,
                         ids=[f"w{w}" for w, _ in RAGGED])
def test_mamba_chunk_matches_the_scanned_decode(w, lengths):
    rcfg, cfg = _cfgs()
    rp, params = _params(rcfg)
    x = _x((4, w, rcfg.d_model), seed=5)
    s0, c0 = _state(rcfg, 4, seed=6)
    ys, ws, wc = _scanned(rp, rcfg, x, s0, c0, lengths)
    got, gs, gc = ssm.mamba_chunk(params, cfg, _t(x), _t(s0), _t(c0),
                                  torch.tensor(lengths, dtype=torch.int32))
    assert got.shape == (4, w, rcfg.d_model)
    for b, n in enumerate(lengths):
        if n:
            np.testing.assert_allclose(got.numpy()[b, :n], np.stack(ys[b]),
                                       err_msg=f"slot {b}", **DUAL)
    np.testing.assert_allclose(gs.numpy(), ws, **DUAL)
    np.testing.assert_allclose(gc.numpy(), wc, **DUAL)
    assert bool(torch.isfinite(got).all())


def test_rows_past_a_length_move_nothing():
    """Rows past ``lengths[b]`` set to other values leave both states and
    the live rows' outputs bit-equal; a slot of length 0 keeps both of its
    states bit for bit."""
    rcfg, cfg = _cfgs()
    _, params = _params(rcfg)
    lengths = [0, 1, 5, 8]
    x = _x((4, 8, rcfg.d_model), seed=7)
    other = x.copy()
    for b, n in enumerate(lengths):
        other[b, n:] = _x((8 - n, rcfg.d_model), seed=20 + b, scale=3.0)
    s0, c0 = (_t(a) for a in _state(rcfg, 4, seed=8))
    lens = torch.tensor(lengths, dtype=torch.int32)
    y1, s1, c1 = ssm.mamba_chunk(params, cfg, _t(x), s0, c0, lens)
    y2, s2, c2 = ssm.mamba_chunk(params, cfg, _t(other), s0, c0, lens)
    assert torch.equal(s1, s2) and torch.equal(c1, c2)
    for b, n in enumerate(lengths):
        assert torch.equal(y1[b, :n], y2[b, :n]), b
    assert torch.equal(s1[0], s0[0]) and torch.equal(c1[0], c0[0])
    assert not torch.equal(s1[1], s0[1])


def test_mamba_chunk_in_bf16_keeps_fp32_state():
    rcfg, cfg = _cfgs()
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    params = ssm.init_mamba(torch.Generator().manual_seed(0), bf16,
                            torch.bfloat16, "cpu")
    x = _t(_x((2, 4, rcfg.d_model), seed=9)).to(torch.bfloat16)
    s0, c0 = _state(rcfg, 2, seed=10)
    y, s, c = ssm.mamba_chunk(params, bf16, x, _t(s0),
                              _t(c0).to(torch.bfloat16),
                              torch.tensor([4, 2]))
    assert y.dtype == torch.bfloat16 and c.dtype == torch.bfloat16
    assert s.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())


# -- the port's mirror of tests/test_ssm.py -----------------------------------


def _naive(params, cfg, x):
    """Token-by-token: the port's decode recurrence from zero state."""
    s, _, di, nh, conv_ch = ssm._dims(cfg)
    B, S, _ = x.shape
    state = torch.zeros((B, nh, s.d_state, s.head_dim))
    conv = torch.zeros((B, s.d_conv - 1, conv_ch), dtype=x.dtype)
    ys = []
    for t in range(S):
        y, state, conv = ssm.mamba_decode(params, cfg, x[:, t:t + 1], state,
                                          conv)
        ys.append(y)
    return torch.cat(ys, dim=1), state, conv


@pytest.mark.parametrize("S,chunk",
                         [(16, 8), (16, 16), (13, 8), (7, 4), (24, 8)])
def test_chunked_matches_naive_recurrence(S, chunk):
    rcfg, cfg = _cfgs(chunk=chunk)
    _, params = _params(rcfg)
    x = _t(_x((2, S, rcfg.d_model), seed=1))
    y, state = ssm.mamba_full(params, cfg, x, return_state=True)
    y_naive, state_naive, _ = _naive(params, cfg, x)
    np.testing.assert_allclose(y.numpy(), y_naive.numpy(), **DUAL)
    np.testing.assert_allclose(state.numpy(), state_naive.numpy(), **DUAL)


def test_chunk_size_is_invisible():
    x = _t(_x((1, 24, 32), seed=2))
    outs = []
    for chunk in (4, 8, 12, 24):
        rcfg, cfg = _cfgs(chunk=chunk)
        _, params = _params(rcfg)
        outs.append(ssm.mamba_full(params, cfg, x).numpy())
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, **DUAL)


def test_decode_continues_prefill_state():
    """A full pass over a prefix, then decode steps, equals a full pass
    over the whole."""
    rcfg, cfg = _cfgs(chunk=4)
    _, params = _params(rcfg)
    S_pre, S_dec = 8, 4
    x = _t(_x((1, S_pre + S_dec, rcfg.d_model), seed=3))
    y_full = ssm.mamba_full(params, cfg, x)
    _, state = ssm.mamba_full(params, cfg, x[:, :S_pre], return_state=True)
    _, conv, _ = ssm._project_in(
        params, cfg, x[:, S_pre - (cfg.ssm.d_conv - 1):S_pre])
    ys = []
    for t in range(S_pre, S_pre + S_dec):
        y, state, conv = ssm.mamba_decode(params, cfg, x[:, t:t + 1], state,
                                          conv)
        ys.append(y)
    np.testing.assert_allclose(y_full[:, S_pre:].numpy(),
                               torch.cat(ys, dim=1).numpy(), rtol=5e-4,
                               atol=5e-4)


def test_chunk_step_continues_prefill_state():
    """The serve path's chunk form carries the state and the conv window
    across chunk boundaries: three chunks of a sequence equal one full
    pass."""
    rcfg, cfg = _cfgs(chunk=4)
    _, params = _params(rcfg)
    x = _t(_x((2, 15, rcfg.d_model), seed=11))
    y_full, s_full = ssm.mamba_full(params, cfg, x, return_state=True)
    state = torch.zeros_like(s_full)
    s = cfg.ssm
    conv = torch.zeros((2, s.d_conv - 1, ssm._dims(cfg)[4]))
    ys = []
    for lo, hi in ((0, 6), (6, 7), (7, 15)):
        y, state, conv = ssm.mamba_chunk(params, cfg, x[:, lo:hi], state,
                                         conv, torch.tensor([hi - lo] * 2))
        ys.append(y)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y_full.numpy(),
                               **DUAL)
    np.testing.assert_allclose(state.numpy(), s_full.numpy(), **DUAL)


def test_initial_state_threading():
    """The state after the whole equals the state after the second half
    run from the first half's state, the conv window handed over as
    pre-conv rows of the first half."""
    rcfg, cfg = _cfgs(chunk=4)
    _, params = _params(rcfg)
    x = _t(_x((1, 16, rcfg.d_model), seed=4))
    _, s_all = ssm.mamba_full(params, cfg, x, return_state=True)
    _, s_half = ssm.mamba_full(params, cfg, x[:, :8], return_state=True)
    _, conv, _ = ssm._project_in(params, cfg, x[:, 8 - 3:8])
    _, s_next, _ = ssm.mamba_chunk(params, cfg, x[:, 8:], s_half, conv,
                                   torch.tensor([8]))
    assert s_all.shape == s_half.shape
    assert bool(torch.isfinite(s_all).all())
    np.testing.assert_allclose(s_next.numpy(), s_all.numpy(), **DUAL)


def test_state_dtype_fp32():
    rcfg, cfg = _cfgs()
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    params = ssm.init_mamba(torch.Generator().manual_seed(0), bf16,
                            torch.bfloat16, "cpu")
    x = torch.randn((1, 8, 32), generator=torch.Generator().manual_seed(5)
                    ).to(torch.bfloat16)
    y, state = ssm.mamba_full(params, bf16, x, return_state=True)
    assert state.dtype == torch.float32
    assert y.dtype == torch.bfloat16


def test_mamba_state_is_fp32():
    cfg = port_configs.get_smoke_config("mamba2-370m")
    bf16 = dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    for c in (cfg, bf16):
        for kv_dtype in ("f32", "bf16", "int8"):
            cache = transformer.init_paged_cache(c, 2, 16, 8, "cpu",
                                                 kv_dtype=kv_dtype)
            assert set(cache) == {"ssm_state", "conv_state"}
            assert cache["ssm_state"].dtype == torch.float32
            assert cache["conv_state"].dtype == transformer.torch_dtype(
                c.compute_dtype)
    init = ssm.init_mamba_cache(bf16, 2, torch.bfloat16, 3, device="cpu")
    assert init["ssm_state"].dtype == torch.float32
    assert tuple(init["conv_state"].shape) == (3, 2, 3, 160)
