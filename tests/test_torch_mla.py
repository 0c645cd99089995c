"""The port's MLA layer (``repro_torch.models.mla``) against the JAX
package's ``repro.models.mla``, on the deepseek-v2-lite smoke config (4
heads, latent 32, rope 8), the same numpy inputs from a seed through both:

* ``mla_decode`` at ragged per-slot positions over paged latent pools
  against the reference's read-only absorbed decode over each slot's
  gathered view (f32, rtol 1e-5: the port commits the new row and attends
  once, the reference merges it in a second softmax step), and the rows it
  commits against the reference's new latent rows;
* token-by-token ``mla_decode`` against the reference's decompressed
  ``mla_full`` (the bound of ``tests/test_mla_moe.py``);
* ``mla_chunk`` against a scan of the reference's one-token decode over
  the chunk (rtol 1e-4, atol 1e-5), rows past a slot's length leaving the
  pools' bytes as they were (but the null block's);
* int8 latent rows: codes and scales bit-equal to the reference's compiled
  ``_quantize_token``;
* the latent pools' shapes, dtypes and ``paged_block_bytes`` equal to the
  reference's for the full and smoke configs and every pool dtype, and
  ``copy_paged_block`` copying ``c``, ``k_rope`` and their scales;
* the mesh rules: ``wq``/``w_uk``/``w_uv`` split their heads and ``wo`` is
  row-parallel on a model axis that divides the heads, ``w_dkv``,
  ``kv_norm`` and the latent pools stay whole, and a model axis that cuts
  a head is refused; the mesh check in a subprocess serves ``mla`` on 1x1,
  2x1, 1x2 and 2x2 to the unsharded and the JAX engine's streams.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.register_assert_rewrite("torch_stateful_checks")

import repro.configs as ref_configs  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
import torch_stateful_checks as checks  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import layers, mla, transformer  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
ARCH = "deepseek-v2-lite-16b"
RCFG = ref_configs.get_smoke_config(ARCH)
CFG = port_configs.get_smoke_config(ARCH)
ML = CFG.mla


def _params(seed=0):
    """The reference's MLA parameters and the port's copy of them."""
    rp = ref_mla.init_mla(jax.random.PRNGKey(seed), RCFG, jnp.float32)
    pp = {k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
          for k, v in rp.items()}
    return rp, pp


def _t(a):
    return torch.from_numpy(np.array(a))


def _paged(rng, B, nb, bs):
    """Latent pools of random rows (the null block included) and a
    shuffled table of nb blocks a slot."""
    n_blocks = 1 + B * nb
    c = rng.standard_normal((n_blocks, bs, ML.kv_lora_rank)).astype(
        np.float32)
    kr = rng.standard_normal((n_blocks, bs, ML.qk_rope_dim)).astype(
        np.float32)
    bt = rng.permutation(np.arange(1, n_blocks)).reshape(B, nb).astype(
        np.int32)
    return c, kr, bt


def _views(c, kr, bt):
    B, nb = bt.shape
    bs = c.shape[1]
    return (c[bt].reshape(B, nb * bs, -1), kr[bt].reshape(B, nb * bs, -1))


def test_params_have_the_reference_names_and_shapes():
    rp, _ = _params()
    own = mla.init_mla(torch.Generator().manual_seed(0), CFG, torch.float32,
                       "cpu")
    assert set(own) == set(rp)
    for name, sub in rp.items():
        assert {k: tuple(v.shape) for k, v in own[name].items()} == \
            {k: tuple(v.shape) for k, v in sub.items()}, name


def test_decode_matches_the_reference_at_ragged_positions():
    rng = np.random.default_rng(0)
    B, nb, bs = 4, 4, 8
    rp, pp = _params()
    c, kr, bt = _paged(rng, B, nb, bs)
    pos = np.array([0, 5, 13, 31], np.int32)
    x = rng.standard_normal((B, 1, CFG.d_model)).astype(np.float32)
    cv, krv = _views(c, kr, bt)
    want, c_new, kr_new = ref_mla.mla_decode(
        rp, RCFG, jnp.asarray(x), jnp.asarray(cv), jnp.asarray(krv),
        jnp.asarray(pos))
    c_pool, kr_pool = _t(c), _t(kr)
    got = mla.mla_decode(pp, CFG, _t(x), c_pool, kr_pool, _t(pos), _t(bt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    rows = bt[np.arange(B), pos // bs], pos % bs
    np.testing.assert_allclose(c_pool.numpy()[rows],
                               np.asarray(c_new)[:, 0], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(kr_pool.numpy()[rows],
                               np.asarray(kr_new)[:, 0], rtol=1e-5,
                               atol=1e-6)
    keep = np.ones(c.shape[:2], bool)
    keep[rows] = False
    assert np.array_equal(c_pool.numpy()[keep], c[keep])
    assert np.array_equal(kr_pool.numpy()[keep], kr[keep])


def test_decode_steps_match_the_reference_full_attention():
    """Absorbed decode token by token over the paged pools equals the
    reference's decompressed full attention (``tests/test_mla_moe.py``'s
    bound)."""
    rp, pp = _params()
    B, S, bs = 2, 10, 4
    x = jax.random.normal(jax.random.PRNGKey(1), (B, S, CFG.d_model),
                          jnp.float32)
    positions = jnp.arange(S, dtype=jnp.int32)[None, :].repeat(B, 0)
    want = ref_mla.mla_full(rp, RCFG, x, positions)
    nb = -(-S // bs)
    c_pool = torch.zeros((1 + B * nb, bs, ML.kv_lora_rank))
    kr_pool = torch.zeros((1 + B * nb, bs, ML.qk_rope_dim))
    bt = torch.arange(1, 1 + B * nb, dtype=torch.int32).reshape(B, nb)
    xt = _t(np.asarray(x))
    ys = [mla.mla_decode(pp, CFG, xt[:, t:t + 1], c_pool, kr_pool,
                         torch.full((B,), t, dtype=torch.int32), bt)
          for t in range(S)]
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(),
                               np.asarray(want), rtol=2e-4, atol=2e-4)


def test_chunk_matches_a_scan_of_the_reference_decode():
    """Slots with history, a ragged chunk (one slot fed nothing): the live
    rows' outputs and committed rows against the reference's one-token
    decode scanned over the chunk; every other row keeps its bytes."""
    rng = np.random.default_rng(1)
    B, nb, bs, w = 4, 4, 8, 6
    rp, pp = _params()
    c, kr, bt = _paged(rng, B, nb, bs)
    pos = np.array([0, 3, 9, 20], np.int32)
    lens = np.array([6, 3, 1, 0], np.int32)
    x = rng.standard_normal((B, w, CFG.d_model)).astype(np.float32)
    cv, krv = (v.copy() for v in _views(c, kr, bt))
    want = np.zeros((B, w, CFG.d_model), np.float32)
    for r in range(w):
        y, c_new, kr_new = ref_mla.mla_decode(
            rp, RCFG, jnp.asarray(x[:, r:r + 1]), jnp.asarray(cv),
            jnp.asarray(krv), jnp.asarray(pos + r))
        for b in np.flatnonzero(r < lens):
            want[b, r] = np.asarray(y)[b, 0]
            cv[b, pos[b] + r] = np.asarray(c_new)[b, 0]
            krv[b, pos[b] + r] = np.asarray(kr_new)[b, 0]
    c_pool, kr_pool = _t(c), _t(kr)
    got = mla.mla_chunk(pp, CFG, _t(x), c_pool, kr_pool, _t(pos), _t(bt),
                        _t(lens))
    assert got.shape == (B, w, CFG.d_model)
    assert torch.isfinite(got).all()
    for b in range(B):
        np.testing.assert_allclose(got.numpy()[b, :lens[b]],
                                   want[b, :lens[b]], rtol=1e-4, atol=1e-5,
                                   err_msg=f"slot {b}")
    got_cv, got_krv = _views(c_pool.numpy(), kr_pool.numpy(), bt)
    np.testing.assert_allclose(got_cv, cv, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_krv, krv, rtol=1e-4, atol=1e-5)
    live = np.zeros((B, nb * bs), bool)
    for b in range(B):
        live[b, pos[b]:pos[b] + lens[b]] = True
    assert np.array_equal(got_cv[~live], _views(c, kr, bt)[0][~live])
    assert np.array_equal(got_krv[~live], _views(c, kr, bt)[1][~live])


def test_int8_rows_equal_the_reference_compiled_quantizer():
    """Codes and scales of committed latent rows bit for bit against the
    reference's jitted ``_quantize_token`` (which multiplies by fp32(1/127)),
    over rows from tiny to large and an all-zero row (scale 1e-8)."""
    rng = np.random.default_rng(2)
    B = 6
    mags = np.array([1e-3, 0.1, 1.0, 7.5, 300.0, 0.0], np.float32)
    quant = jax.jit(lambda d: ref_tf._quantize_token(d, False))
    for width in (ML.kv_lora_rank, ML.qk_rope_dim):
        rows = (rng.standard_normal((B, 1, width)).astype(np.float32)
                * mags[:, None, None])
        q, s = (np.asarray(a) for a in quant(jnp.asarray(rows)))
        pool = torch.zeros((1 + B, 2, width), dtype=torch.int8)
        scale = torch.zeros((1 + B, 2))
        other = torch.zeros((1 + B, 2, 4), dtype=torch.int8)
        bt = torch.arange(1, 1 + B, dtype=torch.int32)[:, None]
        pos = torch.ones(B, dtype=torch.int32)
        dst = mla.step_rows(pos, bt, torch.ones(B, dtype=torch.int32), 1,
                            2).dst
        mla.commit_latent(_t(rows), torch.zeros((B, 1, 4)), pool, other, dst,
                          scale, torch.zeros((1 + B, 2)))
        assert np.array_equal(pool.numpy()[1:, 1], q[:, 0])
        assert np.array_equal(scale.numpy()[1:, 1], s[:, 0])
        assert not pool[:, 0].any() and not scale[:, 0].any()


@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_latent_pools_and_block_bytes_match_the_reference(size, kv_dtype):
    get = "get_config" if size == "full" else "get_smoke_config"
    cfg = getattr(port_configs, get)(ARCH)
    rcfg = getattr(ref_configs, get)(ARCH)
    assert transformer.paged_block_bytes(cfg, 16, kv_dtype) == \
        ref_tf.paged_block_bytes(rcfg, 16, kv_dtype)
    rcache = jax.eval_shape(lambda: ref_tf.init_paged_cache(
        rcfg, 2, 32, 16, kv_dtype=kv_dtype))
    blocks, first = rcache["blocks"]["slot0"], rcache["first_block"]
    want = {k: ((1 + blocks[k].shape[0],) + blocks[k].shape[1:],
                str(blocks[k].dtype)) for k in blocks}
    assert all(first[k].shape == blocks[k].shape[1:] for k in blocks)
    assert set(want) == ({"c", "k_rope", "c_scale", "k_rope_scale"}
                         if kv_dtype == "int8" else {"c", "k_rope"})
    cache = transformer.init_paged_cache(cfg, 2, 32, 16, "cpu",
                                         kv_dtype=kv_dtype)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[1])
            for k, v in cache.items()} == want


def test_copy_paged_block_copies_latents_and_their_scales():
    cache = transformer.init_paged_cache(CFG, 3, 16, 8, "cpu",
                                         kv_dtype="int8")
    gen = torch.Generator().manual_seed(0)
    for v in cache.values():
        v.copy_(torch.randint(-100, 100, v.shape, generator=gen).to(v.dtype))
    before = {k: v.clone() for k, v in cache.items()}
    assert transformer.copy_paged_block(cache, 2, 5) is cache
    assert set(cache) == {"c", "k_rope", "c_scale", "k_rope_scale"}
    for key, v in cache.items():
        assert torch.equal(v[:, 5], before[key][:, 2])
        keep = [b for b in range(v.shape[1]) if b != 5]
        assert torch.equal(v[:, keep], before[key][:, keep])
    copied = {k: v.clone() for k, v in cache.items()}
    assert transformer.reset_paged_slots(cache, np.ones(3, bool)) is cache
    assert all(torch.equal(v, copied[k]) for k, v in cache.items())


class _Rank(MeshShape):
    """Rank 0's view of a mesh shape: what ``MeshContext`` reads."""

    def axis_index(self, name):
        return 0


@pytest.mark.parametrize("shape,split", [((1, 1), False), ((2, 1), False),
                                         ((1, 2), True), ((2, 2), True),
                                         ((1, 4), True)])
def test_mesh_splits_heads_and_keeps_the_latent_whole(shape, split):
    mesh = _Rank(*shape)
    tp = layers.MeshContext(mesh, CFG, 4)
    assert tp.mla_split == split and not tp.heads
    specs = sharding.serve_param_shardings(checks.model(ARCH).params, mesh)
    first = specs["layers"][0]["mla"]

    def cut(spec):  # split over a model axis of more than one rank
        return mesh.model > 1 and "model" in spec

    for name in ("wq", "w_uk", "w_uv"):
        assert cut(first[name]["w"]) == split, name
        assert first[name]["w"][0] is None
    assert cut(first["wo"]["w"][:1]) == split
    assert not cut(first["w_dkv"]["w"])
    assert not cut(first["kv_norm"]["scale"])
    cache = transformer.init_paged_cache(CFG, 4, 32, 8, "cpu",
                                         kv_dtype="int8", mesh=mesh)
    whole = transformer.init_paged_cache(CFG, 4, 32, 8, "cpu",
                                         kv_dtype="int8")
    assert {k: v.shape for k, v in cache.items()} == \
        {k: v.shape for k, v in whole.items()}


def test_a_model_axis_that_cuts_a_head_is_refused():
    with pytest.raises(ValueError, match="MLA projections"):
        layers.MeshContext(_Rank(1, 8), CFG, 4)


def test_cross_mesh_streams_equal_the_jax_engine(tmp_path):
    m = checks.model(ARCH)
    checks.check_mesh_verdict(m, "mla", checks.mesh_verdict(m, "mla",
                                                            tmp_path))
