"""Quantized paging in the port against the JAX package: the plain int8
quantizer, the int8 and bf16-pool paged decode and chunked prefill, the
paged cache's storage dtypes, and teacher-forced logits.

On the CPU the wrappers run their plain versions (``ref.py``).  Held:
- ``quantize_rows`` bit-equal to the reference's as JAX compiles it
  (codes and scales): under ``jit``, and so in the Pallas commit and the
  serving cell, XLA turns ``amax / 127`` into a product with 127's fp32
  reciprocal, which the port follows; the reference's eager call divides,
  and its scales are then within one ulp of the port's;
- the plain decode and prefill on int8 pools (with scales) and on bf16
  pools under an f32 query against the Pallas kernels in interpret mode,
  within 3e-5 (the reference's own kernel-vs-oracle bound); the prefill's
  committed codes and scales bit-equal through the block tables; a lone
  scale rejected; int8 rows and scales past ``valid_len`` inert;
- ``init_paged_cache``, ``paged_block_bytes`` and ``copy_paged_block``
  against the reference's for every ``kv_dtype`` and both dense archs;
- teacher-forced logits under bf16/int8 pools within the reference's own
  budgets (``tests/test_serve_sharing.py``'s ``_KV_TOL``) of the port's
  f32 cache and of the JAX package's f32 cell.  The port commits the new
  row before it attends, so the new token sees its own quantized K/V; the
  reference's cell merges it unquantized.  Port and JAX under the same
  ``kv_dtype`` therefore differ by more than f32 rounding: measured at
  this configuration 0.0047 / 0.0146 (gpt2-124m bf16 / int8) and 0.0077 /
  0.0242 (qwen3-1.7b); held at about twice that (``_SAME_DTYPE_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.kernels.flash_decode import kernel as pallas  # noqa: E402
from repro.kernels.flash_decode import ref as ref_oracle  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.kernels.flash_decode import kernel, ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
TOL = 3e-5
ARCHS = ("gpt2-124m", "qwen3-1.7b")
#: the reference's teacher-forced budgets against the f32 cache
_KV_TOL = {"gpt2-124m": {"bf16": 0.02, "int8": 0.06},
           "qwen3-1.7b": {"bf16": 0.03, "int8": 0.11}}
#: port against JAX under the same kv_dtype (see the module docstring)
_SAME_DTYPE_TOL = {"gpt2-124m": {"bf16": 0.01, "int8": 0.03},
                   "qwen3-1.7b": {"bf16": 0.015, "int8": 0.05}}


def _t(a):
    """A private, writable torch copy of a numpy (or JAX) array."""
    return torch.from_numpy(np.array(a))


def _quantized_inputs(B, KV, G, D, bs, nb, seed=0):
    """numpy q, f32 pools, their int8 codes and scales by the reference's
    quantizer, shuffled tables (block 0 unnamed) and ragged lengths
    including 1 and the full length."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * nb
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    k = rng.standard_normal((n_blocks, bs, KV, D)).astype(np.float32)
    v = rng.standard_normal((n_blocks, bs, KV, D)).astype(np.float32)
    kq, ks = (np.asarray(a) for a in ref_oracle.quantize_rows(k))
    vq, vs = (np.asarray(a) for a in ref_oracle.quantize_rows(v))
    bt = rng.permutation(np.arange(1, n_blocks))[: B * nb].reshape(B, nb)
    valid = rng.integers(1, nb * bs + 1, size=B)
    valid[0], valid[-1] = 1, nb * bs
    return (q, k, v, kq, vq, ks, vs, bt.astype(np.int32),
            valid.astype(np.int32))


# -- the quantizer ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(5, 8, 2, 16), (3, 16, 8, 128),
                                   (2, 4, 12, 64)])
def test_quantize_rows_is_bit_equal_to_the_reference(shape):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30.0,
                                                  shape[:2] + (1, 1)))
    x = x.astype(np.float32)
    x[0, 0] = 0.0                   # an all-zero row: scale 1e-8, codes 0
    x[0, 1, 0, 0] = 127.0 * 0.5     # ties: x / s lands on .5 steps
    x[0, 1, 0, 1] = -127.0
    x[0, 1, 0, 2] = 2.5
    codes, scales = ref.quantize_rows(_t(x))
    want_codes, want_scales = jax.jit(ref_oracle.quantize_rows)(
        jnp.asarray(x))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_scales))
    np.testing.assert_array_equal(
        ref.dequantize_pool(codes, scales).numpy(),
        np.asarray(ref_oracle.dequantize_pool(want_codes, want_scales)))
    _, eager_scales = ref_oracle.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_max_ulp(scales.numpy(),
                                    np.asarray(eager_scales), maxulp=1)


# -- paged decode -------------------------------------------------------------


@pytest.mark.parametrize("B,KV,G,D,bs,nb", [
    (1, 1, 1, 16, 8, 4),
    (3, 2, 2, 16, 4, 6),
    (2, 4, 2, 32, 16, 2),
    (4, 12, 1, 64, 16, 3),   # gpt2-124m heads
    (2, 8, 2, 128, 16, 2),   # qwen3-1.7b heads
])
def test_int8_decode_matches_pallas_and_oracle(B, KV, G, D, bs, nb):
    q, k, v, kq, vq, ks, vs, bt, valid = _quantized_inputs(
        B, KV, G, D, bs, nb)
    out = kernel.flash_decode_paged(_t(q), _t(kq), _t(vq), _t(bt),
                                    _t(valid), _t(ks), _t(vs)).numpy()
    jx = [jnp.asarray(a) for a in (q, kq, vq, bt, valid)]
    scales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    want = pallas.flash_decode_paged(*jx, **scales, interpret=True)
    oracle = ref_oracle.decode_paged_ref(*jx, **scales)
    np.testing.assert_allclose(out, np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, np.asarray(oracle), rtol=TOL, atol=TOL)
    # and within quantization error of the f32 pools, as the reference
    f32 = ref_oracle.decode_paged_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jx[3], jx[4])
    np.testing.assert_allclose(out, np.asarray(f32), atol=0.08)


@pytest.mark.parametrize("D", [16, 64])
def test_bf16_pools_under_f32_q_match_pallas(D):
    q, k, v, _, _, _, _, bt, valid = _quantized_inputs(2, 2, 2, D, 8, 4,
                                                       seed=2)
    kb, vb = _t(k).to(torch.bfloat16), _t(v).to(torch.bfloat16)
    out = kernel.flash_decode_paged(_t(q), kb, vb, _t(bt), _t(valid))
    assert out.dtype == torch.float32
    jk = jnp.asarray(k).astype(jnp.bfloat16)
    jv = jnp.asarray(v).astype(jnp.bfloat16)
    want = pallas.flash_decode_paged(jnp.asarray(q), jk, jv, jnp.asarray(bt),
                                     jnp.asarray(valid), interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_int8_pools_under_a_bf16_q():
    """(bf16, int8) is a served pair: the plain version against the f32
    oracle on the same dequantized pools, at bf16's rounding."""
    q, _, _, kq, vq, ks, vs, bt, valid = _quantized_inputs(3, 2, 2, 32, 8, 4,
                                                           seed=3)
    qb = _t(q).to(torch.bfloat16)
    out = kernel.flash_decode_paged(qb, _t(kq), _t(vq), _t(bt), _t(valid),
                                    _t(ks), _t(vs))
    assert out.dtype == torch.bfloat16
    want = ref_oracle.decode_paged_ref(
        jnp.asarray(qb.float().numpy()), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(bt), jnp.asarray(valid), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(out.float().numpy(), np.asarray(want),
                               rtol=1e-2, atol=1e-2)


def test_int8_decode_rejects_a_lone_scale_and_bad_pairs():
    q, _, _, kq, vq, ks, vs, bt, valid = _quantized_inputs(1, 1, 1, 16, 8, 4)
    args = [_t(a) for a in (q, kq, vq, bt, valid)]
    with pytest.raises(ValueError):   # as the reference's kernel
        pallas.flash_decode_paged(*[jnp.asarray(a)
                                    for a in (q, kq, vq, bt, valid)],
                                  k_scale=jnp.asarray(ks))
    with pytest.raises(ValueError, match="together"):
        kernel.flash_decode_paged(*args, k_scale=_t(ks))
    with pytest.raises(ValueError, match="int8 pools need"):
        kernel.flash_decode_paged(*args)
    with pytest.raises(TypeError, match="not served"):
        kernel.flash_decode_paged(args[0].to(torch.bfloat16),
                                  *[a.float() for a in args[1:3]], *args[3:])
    with pytest.raises(ValueError, match="k_scale must be"):
        kernel.flash_decode_paged(*args, _t(ks[:, :4]), _t(vs[:, :4]))


def test_int8_stale_rows_and_scales_are_inert():
    """Poisoning int8 rows and their scales past valid_len changes nothing:
    the rows past the length are masked before they meet the softmax."""
    B, KV, G, D, bs, nb = 2, 2, 2, 16, 4, 4
    q, _, _, kq, vq, ks, vs, bt, _ = _quantized_inputs(B, KV, G, D, bs, nb,
                                                       seed=5)
    valid = np.array([6, 11], np.int32)
    out1 = kernel.flash_decode_paged(_t(q), _t(kq), _t(vq), _t(bt),
                                     _t(valid), _t(ks), _t(vs))
    kp, vp, ksp, vsp = kq.copy(), vq.copy(), ks.copy(), vs.copy()
    for b in range(B):
        for t in range(int(valid[b]), nb * bs):
            blk, o = int(bt[b, t // bs]), t % bs
            kp[blk, o], vp[blk, o] = 127, -127
            ksp[blk, o] = vsp[blk, o] = 99.0
    out2 = kernel.flash_decode_paged(_t(q), _t(kp), _t(vp), _t(bt),
                                     _t(valid), _t(ksp), _t(vsp))
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())


# -- chunked prefill ----------------------------------------------------------


def _prefill_inputs(B, C, KV, G, D, bs, nb, seed=11):
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * nb + 2      # two blocks no table names
    kq, ks = (np.asarray(a) for a in ref_oracle.quantize_rows(
        rng.standard_normal((n_blocks, bs, KV, D)).astype(np.float32)))
    vq, vs = (np.asarray(a) for a in ref_oracle.quantize_rows(
        rng.standard_normal((n_blocks, bs, KV, D)).astype(np.float32)))
    bt = rng.permutation(np.arange(1, n_blocks))[: B * nb].reshape(B, nb)
    k_new = rng.standard_normal((B, C, KV, D)).astype(np.float32)
    v_new = rng.standard_normal((B, C, KV, D)).astype(np.float32)
    q = rng.standard_normal((B, C, KV, G, D)).astype(np.float32)
    q_start = rng.integers(0, nb * bs - C + 1, B).astype(np.int32)
    q_len = rng.integers(1, C + 1, B).astype(np.int32)
    q_len[0] = C
    return (q, k_new, v_new, kq, vq, bt.astype(np.int32), q_start, q_len,
            ks, vs)


@pytest.mark.parametrize("B,C,KV,G,D,bs,nb,bc,bks", [
    (1, 8, 1, 1, 16, 8, 4, 8, 0),
    (2, 8, 2, 2, 16, 8, 6, 4, 8),
    (3, 4, 1, 2, 16, 4, 8, 2, 4),
    (2, 8, 8, 2, 128, 16, 3, 8, 0),   # qwen3-1.7b heads
])
def test_int8_prefill_matches_pallas_bit_equal_commit(B, C, KV, G, D, bs, nb,
                                                      bc, bks):
    """The quantizing commit gives codes and scales bit-equal to the
    Pallas commit through the tables, leaves unnamed blocks as they were,
    and the attended rows match the Pallas kernel."""
    arrays = _prefill_inputs(B, C, KV, G, D, bs, nb)
    q, k_new, v_new, kq, vq, bt, q_start, q_len, ks, vs = arrays
    t = [_t(a) for a in arrays]
    out, kp, vp, ks2, vs2 = kernel.flash_prefill(
        *t[:8], k_scale=t[8].clone(), v_scale=t[9].clone(), block_c=bc,
        block_s=bks)
    # the port commits in place: the returned pools are the given ones
    assert kp is t[3] and vp is t[4]
    jx = [jnp.asarray(a) for a in arrays]
    jout, jkp, jvp, jks, jvs = pallas.flash_prefill_paged(
        *jx[:8], k_scale=jx[8], v_scale=jx[9], block_c=bc, block_s=bks,
        interpret=True)
    named = np.unique(bt)
    for got, want in ((kp, jkp), (vp, jvp), (ks2, jks), (vs2, jvs)):
        np.testing.assert_array_equal(got.numpy()[named],
                                      np.asarray(want)[named])
    unnamed = np.setdiff1d(np.arange(kq.shape[0]), named)
    for got, before in ((kp, kq), (vp, vq), (ks2, ks), (vs2, vs)):
        np.testing.assert_array_equal(got.numpy()[unnamed], before[unnamed])
    valid = np.arange(C)[None, :] < q_len[:, None]
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(jout)[valid],
                               rtol=TOL, atol=TOL)
    assert not out.numpy()[~valid].any()


def test_bf16_pool_prefill_under_f32_q_matches_pallas():
    arrays = _prefill_inputs(2, 8, 2, 2, 16, 8, 4, seed=12)
    q, k_new, v_new, kq, vq, bt, q_start, q_len, ks, vs = arrays
    rng = np.random.default_rng(0)
    kb = rng.standard_normal(kq.shape).astype(np.float32)
    vb = rng.standard_normal(vq.shape).astype(np.float32)
    t = [_t(a) for a in (q, k_new, v_new)]
    kp, vp = _t(kb).to(torch.bfloat16), _t(vb).to(torch.bfloat16)
    out, kp, vp = kernel.flash_prefill(*t, kp, vp, _t(bt), _t(q_start),
                                       _t(q_len))
    # the Pallas commit takes the new rows in the pools' dtype (the
    # reference's model casts them first); the port's converts them itself
    jout, jkp, jvp = pallas.flash_prefill_paged(
        jnp.asarray(q), jnp.asarray(k_new).astype(jnp.bfloat16),
        jnp.asarray(v_new).astype(jnp.bfloat16),
        jnp.asarray(kb).astype(jnp.bfloat16),
        jnp.asarray(vb).astype(jnp.bfloat16), jnp.asarray(bt),
        jnp.asarray(q_start), jnp.asarray(q_len), interpret=True)
    named = np.unique(bt)
    np.testing.assert_array_equal(kp.float().numpy()[named],
                                  np.asarray(jkp.astype(jnp.float32))[named])
    np.testing.assert_array_equal(vp.float().numpy()[named],
                                  np.asarray(jvp.astype(jnp.float32))[named])
    valid = np.arange(8)[None, :] < q_len[:, None]
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(jout)[valid],
                               rtol=TOL, atol=TOL)


def test_int8_prefill_rejects_a_lone_scale():
    t = [_t(a) for a in _prefill_inputs(1, 8, 1, 1, 16, 8, 4)]
    with pytest.raises(ValueError, match="together"):
        kernel.flash_prefill(*t[:8], k_scale=t[8])
    with pytest.raises(ValueError, match="together"):
        kernel.flash_prefill_paged(*t[:8], t[8], None)


def test_commit_alone_quantizes_as_the_chunk_commit():
    """``commit_paged`` (a decode step's commit, a chunk of one) writes the
    same codes and scales as the prefill's commit."""
    arrays = _prefill_inputs(2, 8, 2, 2, 16, 8, 4, seed=13)
    t1 = [_t(a) for a in arrays]
    t2 = [_t(a) for a in arrays]
    kernel.flash_prefill_paged(*t1)
    kernel.commit_paged(*t2[1:8], t2[8], t2[9])
    for i in (3, 4, 8, 9):
        assert torch.equal(t1[i], t2[i]), i


# -- the paged cache ----------------------------------------------------------


def _ref_leaves(cache):
    return cache["blocks"]["slot0"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_paged_cache_block_bytes_and_copy_match_the_reference(arch,
                                                              kv_dtype):
    cfg = port_configs.get_smoke_config(arch)
    rcfg = ref_configs.get_smoke_config(arch)
    cache = transformer.init_paged_cache(cfg, 3, 32, 8, "cpu",
                                         kv_dtype=kv_dtype)
    rcache = ref_tf.init_paged_cache(rcfg, 3, 32, 8, kv_dtype=kv_dtype)
    leaves = _ref_leaves(rcache)
    assert set(cache) == set(leaves)
    for key, pool in cache.items():
        want = leaves[key]
        assert tuple(pool.shape) == want.shape, key
        assert str(pool.dtype).split(".")[1] == \
            {"float32": "float32", "bfloat16": "bfloat16",
             "int8": "int8"}[str(want.dtype)], key
        assert not pool.any(), key
    assert transformer.paged_block_bytes(cfg, 8, kv_dtype) == \
        ref_tf.paged_block_bytes(rcfg, 8, kv_dtype)

    rng = np.random.default_rng(0)
    filled = {}
    for key, pool in cache.items():
        a = rng.standard_normal(tuple(pool.shape)) * 50
        filled[key] = a.astype(np.asarray(leaves[key]).dtype)
        pool.copy_(_t(filled[key].astype(np.float32)).to(pool.dtype))
    rfilled = dict(rcache, blocks={"slot0": {
        k: jnp.asarray(a) for k, a in filled.items()}})
    out = transformer.copy_paged_block(cache, 2, 5)
    assert out is cache
    want = _ref_leaves(ref_tf.copy_paged_block(rfilled, jnp.int32(2),
                                               jnp.int32(5)))
    for key, pool in cache.items():
        np.testing.assert_array_equal(
            pool.float().numpy(), np.asarray(want[key]).astype(np.float32),
            err_msg=key)


def test_unknown_kv_dtype_and_mismatched_cache_are_refused():
    cfg = port_configs.get_smoke_config("gpt2-124m")
    with pytest.raises(ValueError, match="kv_dtype"):
        transformer.init_paged_cache(cfg, 1, 16, 8, "cpu", kv_dtype="fp8")
    with pytest.raises(ValueError, match="kv_dtype"):
        transformer.paged_block_bytes(cfg, 8, "fp8")
    params = transformer.init_lm(cfg, seed=0, device="cpu")
    cache = transformer.init_paged_cache(cfg, 1, 16, 8, "cpu",
                                         kv_dtype="int8")
    zeros = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="kv_dtype"):
        transformer.decode_step_paged(
            params, cfg, torch.zeros((1, 1), dtype=torch.int32), cache,
            zeros, torch.ones((1, 2), dtype=torch.int32), block_size=8)


# -- teacher-forced logits ----------------------------------------------------

_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        rcfg = ref_configs.get_smoke_config(arch)
        cfg = port_configs.get_smoke_config(arch)
        rp = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
        pp = transformer.params_from_numpy(jax.tree.map(np.asarray, rp), cfg,
                                           "cpu")
        _MODELS[arch] = (rcfg, rp, cfg, pp)
    return _MODELS[arch]


def _forced_tokens(vocab, B=2, T=14):
    rng = np.random.default_rng(13)
    return rng.integers(0, vocab, (B, T)).astype(np.int32)


def _port_logits(arch, kv_dtype, chunked=False):
    """The reference test's configuration: 2 slots, 14 forced tokens,
    max_len 32, blocks of 8; token by token, or the 14 tokens as one chunk
    (the logits of every row)."""
    _, _, cfg, params = _models(arch)
    toks = _forced_tokens(cfg.vocab)
    B, T = toks.shape
    bt = torch.arange(1, 1 + B * 4, dtype=torch.int32).reshape(B, 4)
    cache = transformer.init_paged_cache(cfg, B, 32, 8, "cpu",
                                         kv_dtype=kv_dtype)
    if chunked:
        logits, _ = transformer.prefill_step_paged(
            params, cfg, _t(toks), cache, torch.zeros(B, dtype=torch.int32),
            bt, torch.full((B,), T, dtype=torch.int32), block_size=8,
            kv_dtype=kv_dtype)
        return logits.transpose(0, 1)[:, :, None].numpy()
    out = []
    for t in range(T):
        logits, cache = transformer.decode_step_paged(
            params, cfg, _t(toks[:, t:t + 1]), cache,
            torch.full((B,), t, dtype=torch.int32), bt, block_size=8,
            kv_dtype=kv_dtype)
        out.append(logits.numpy())
    return np.stack(out)


def _jax_logits(arch, kv_dtype):
    rcfg, rp, _, _ = _models(arch)
    toks = _forced_tokens(rcfg.vocab)
    B, T = toks.shape
    bt = jnp.asarray(np.arange(1, 1 + B * 4, dtype=np.int32).reshape(B, 4))
    cache = ref_tf.init_paged_cache(rcfg, B, 32, 8, kv_dtype=kv_dtype)
    out = []
    for t in range(T):
        logits, cache = ref_tf.decode_step_paged(
            rp, rcfg, jnp.asarray(toks[:, t:t + 1]), cache,
            jnp.full((B,), t, jnp.int32), bt, block_size=8,
            kv_dtype=kv_dtype)
        out.append(np.asarray(logits))
    return np.stack(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_logits_within_the_reference_budgets(arch):
    port = {kd: _port_logits(arch, kd) for kd in ("f32", "bf16", "int8")}
    jax_f32 = _jax_logits(arch, "f32")
    np.testing.assert_allclose(port["f32"], jax_f32, rtol=1e-4, atol=1e-5)
    for kd in ("bf16", "int8"):
        tol = _KV_TOL[arch][kd]
        assert np.abs(port[kd] - port["f32"]).max() <= tol, (arch, kd)
        assert np.abs(port[kd] - jax_f32).max() <= tol, (arch, kd)
        same = np.abs(port[kd] - _jax_logits(arch, kd)).max()
        assert same <= _SAME_DTYPE_TOL[arch][kd], (arch, kd, same)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_chunked_teacher_forced_matches_token_by_token(arch, kv_dtype):
    """The chunk step quantizes rows with the decode step's formula, so
    the 14 forced tokens as one chunk give the token-by-token logits up to
    f32 rounding of the two paths' K/V (no code flips at this size)."""
    np.testing.assert_allclose(_port_logits(arch, kv_dtype, chunked=True),
                               _port_logits(arch, kv_dtype), rtol=1e-4,
                               atol=1e-4)
