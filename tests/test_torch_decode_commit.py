"""The paged decode that commits each slot's new row in the same call
(``flash_decode_paged(..., k_new=, v_new=)``), on the CPU.

* It equals the two calls a decode layer made before, the commit
  (``commit_paged`` with ``q_start = valid_len - 1`` and ``q_len`` of ones)
  then the decode, bit for bit: output, pools and int8 scales, for every
  (q, pool) dtype pair, and for the head slices of ``head_shard`` given
  their heads of the rows (and for int8 pools each row's amax over all
  heads), concatenated.
* ``attention_decode_paged``, which now makes that one call and no
  ``commit_paged`` call unsharded, equals the JAX decode cell as
  ``tests/test_torch_cell.py`` holds it: live slots' logits and the pools
  outside NULL_BLOCK at f32 rtol 1e-4, atol 1e-5.
* The argument checks raise: ``k_new`` shape, dtype or alone, amax
  without int8 pools or without ``k_new``, int8 under ``head_shard``
  without amax.
The kernel itself is held to the same pair on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.kernels.flash_decode import kernel, ref  # noqa: E402
from repro_torch.models import attention, transformer  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.float32, torch.int8), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.int8)]
PAIR_IDS = ["f32-f32", "f32-bf16", "f32-int8", "bf16-bf16", "bf16-int8"]
B, KV, G, D, BS, NB = 4, 4, 2, 16, 4, 3


def _inputs(q_dtype, pool_dtype, seed=0):
    """q, pools (and int8 scales), a shuffled table, lengths 1 .. nb*bs
    (one row, a block edge, the whole table) and each slot's new rows."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * NB
    f = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
         for s in ((B, KV, G, D), (n_blocks, BS, KV, D),
                   (n_blocks, BS, KV, D), (B, KV, D), (B, KV, D))]
    q, kp, vp, k_new, v_new = f
    if pool_dtype == torch.int8:
        (kp, ks), (vp, vs) = ref.quantize_rows(kp), ref.quantize_rows(vp)
    else:
        kp, vp, ks, vs = kp.to(pool_dtype), vp.to(pool_dtype), None, None
    bt = rng.permutation(np.arange(1, n_blocks))[:B * NB].reshape(B, NB)
    vl = np.array([1, BS, BS + 1, NB * BS], np.int32)
    return (q.to(q_dtype), [kp, vp, ks, vs],
            torch.from_numpy(bt.astype(np.int32)), torch.from_numpy(vl),
            k_new.to(q_dtype), v_new.to(q_dtype))


def _clone(pools):
    return [None if t is None else t.clone() for t in pools]


def _pair(q, pools, bt, vl, k_new, v_new):
    kernel.commit_paged(k_new[:, None], v_new[:, None], pools[0], pools[1],
                        bt, vl - 1, torch.ones_like(vl), *pools[2:])
    return kernel.flash_decode_paged(q, pools[0], pools[1], bt, vl,
                                     *pools[2:])


def _assert_pools_equal(got, want):
    for a, w in zip(got, want):
        if w is not None:
            assert torch.equal(a, w)


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
def test_fused_call_is_the_commit_then_the_decode(pair):
    q, pools, bt, vl, k_new, v_new = _inputs(*pair)
    want_pools = _clone(pools)
    want = _pair(q, want_pools, bt, vl, k_new, v_new)
    got_pools = _clone(pools)
    got = kernel.flash_decode_paged(q, got_pools[0], got_pools[1], bt, vl,
                                    *got_pools[2:], k_new=k_new, v_new=v_new)
    assert torch.equal(got, want)
    _assert_pools_equal(got_pools, want_pools)
    # the rows landed where the commit puts them, and changed the pools
    assert not all(torch.equal(a, w) for a, w in zip(got_pools[:2],
                                                     pools[:2]))


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("n", [2, 4])
def test_fused_head_slices_are_the_unsharded_pair(pair, n):
    q, pools, bt, vl, k_new, v_new = _inputs(*pair, seed=n)
    want_pools = _clone(pools)
    want = _pair(q, want_pools, bt, vl, k_new, v_new)
    amax = {}
    if pair[1] == torch.int8:
        amax = dict(k_amax=ref.row_amax(k_new), v_amax=ref.row_amax(v_new))
    got_pools = _clone(pools)
    parts = []
    for i in range(n):
        h = ref.head_slice((i, n), KV)
        parts.append(kernel.flash_decode_paged(
            q, got_pools[0], got_pools[1], bt, vl, *got_pools[2:],
            head_shard=(i, n), k_new=k_new[:, h].contiguous(),
            v_new=v_new[:, h].contiguous(), **amax))
    assert torch.equal(torch.cat(parts, dim=1), want)
    _assert_pools_equal(got_pools, want_pools)


def test_sharded_wrapper_passes_the_rows_through():
    from repro_torch.launch.mesh import MeshShape

    q, pools, bt, vl, k_new, v_new = _inputs(torch.float32, torch.int8, 7)
    want_pools = _clone(pools)
    want = _pair(q, want_pools, bt, vl, k_new, v_new)
    got_pools = _clone(pools)
    got = kernel.flash_decode_paged_sharded(
        q, got_pools[0], got_pools[1], bt, vl, mesh=MeshShape(1, 1),
        k_scale=got_pools[2], v_scale=got_pools[3], k_new=k_new,
        v_new=v_new, k_amax=ref.row_amax(k_new), v_amax=ref.row_amax(v_new))
    assert torch.equal(got, want)
    _assert_pools_equal(got_pools, want_pools)


def _schedule(seed, b=4, max_len=32, bs=8, steps=12):
    """As tests/test_torch_cell.py: slot 3 idle in NULL_BLOCK throughout,
    slot 2 admitted at step 4, shuffled tables."""
    rng = np.random.default_rng(seed)
    nb = max_len // bs
    tables = rng.permutation(np.arange(1, 1 + b * nb)).reshape(b, nb)
    tables = tables.astype(np.int32)
    tables[3] = 0
    start = np.array([0, 0, 4, 0])
    for step in range(steps):
        live = [s for s in range(b) if s != 3 and step >= start[s]]
        pos = np.array([step - start[s] if s in live else 0
                        for s in range(b)], np.int32)
        bt = tables.copy()
        bt[[s for s in range(b) if s not in live]] = 0
        tokens = rng.integers(0, 256, size=(b, 1)).astype(np.int32)
        yield tokens, pos, bt, live


@pytest.mark.parametrize("arch", ["gpt2-124m", "qwen3-1.7b"])
def test_decode_layer_makes_one_call_and_matches_reference(arch,
                                                           monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("an unsharded decode step called commit_paged")

    monkeypatch.setattr(attention, "commit_paged", refuse)
    calls = []
    fused = attention.flash_decode_paged

    def counted(*args, **kwargs):
        calls.append(kwargs.get("k_new") is not None)
        return fused(*args, **kwargs)

    monkeypatch.setattr(attention, "flash_decode_paged", counted)
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = port_configs.get_smoke_config(arch)
    ref_params = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
    params = transformer.params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    ref_cache = ref_tf.init_paged_cache(rcfg, 4, 32, 8)
    cache = transformer.init_paged_cache(cfg, 4, 32, 8, "cpu")
    ref_step = jax.jit(lambda p, t, c, pos, bt: ref_tf.decode_step_paged(
        p, rcfg, t, c, pos, bt, block_size=8))
    steps = 0
    for tokens, pos, bt, live in _schedule(seed=2):
        want, ref_cache = ref_step(ref_params, tokens, ref_cache, pos, bt)
        got, cache = transformer.decode_step_paged(
            params, cfg, torch.from_numpy(tokens), cache,
            torch.from_numpy(pos), torch.from_numpy(bt), block_size=8)
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live],
                                   rtol=1e-4, atol=1e-5)
        for key in ("k", "v"):
            pool = np.asarray(ref_cache["blocks"]["slot0"][key])
            np.testing.assert_allclose(cache[key].numpy()[:, 1:],
                                       pool[:, 1:], rtol=1e-4, atol=1e-5)
        steps += 1
    assert calls == [True] * (steps * cfg.n_layers)


def _call(pair=(torch.float32, torch.int8), **kw):
    q, pools, bt, vl, k_new, v_new = _inputs(*pair)
    args = dict(k_new=k_new, v_new=v_new)
    args.update(kw)
    return kernel.flash_decode_paged(q, pools[0], pools[1], bt, vl,
                                     *pools[2:], **args)


@pytest.mark.parametrize("kw,error,match", [
    (dict(k_new=torch.zeros(B, KV, D + 1)), ValueError, r"k_new must be"),
    (dict(v_new=torch.zeros(B, 1, KV, D)), ValueError, r"v_new must be"),
    (dict(k_new=torch.zeros(B, KV, D, dtype=torch.bfloat16)), TypeError,
     "q's dtype"),
    (dict(v_new=None), ValueError, "together"),
    (dict(k_new=torch.zeros(B, KV, 2 * D)[..., ::2]), ValueError,
     "contiguous"),
    (dict(k_amax=torch.ones(B)), ValueError, "together"),
    (dict(k_amax=torch.ones(B, 1), v_amax=torch.ones(B, 1)), ValueError,
     r"\(4,\) float32"),
])
def test_fused_call_checks_its_rows(kw, error, match):
    with pytest.raises(error, match=match):
        _call(**kw)


def test_amax_needs_int8_pools_and_rows():
    with pytest.raises(ValueError, match="only with int8"):
        _call((torch.float32, torch.bfloat16), k_amax=torch.ones(B),
              v_amax=torch.ones(B))
    with pytest.raises(ValueError, match="come with k_new"):
        _call(k_new=None, v_new=None, k_amax=torch.ones(B),
              v_amax=torch.ones(B))


def test_int8_slices_need_the_rows_amax():
    q, pools, bt, vl, k_new, v_new = _inputs(torch.float32, torch.int8)
    h = ref.head_slice((0, 2), KV)
    with pytest.raises(ValueError, match="head_shard need k_amax"):
        kernel.flash_decode_paged(q, pools[0], pools[1], bt, vl, *pools[2:],
                                  head_shard=(0, 2),
                                  k_new=k_new[:, h].contiguous(),
                                  v_new=v_new[:, h].contiguous())
    with pytest.raises(ValueError, match=r"k_new must be \(4, 2, 16\)"):
        kernel.flash_decode_paged(q, pools[0], pools[1], bt, vl, *pools[2:],
                                  head_shard=(0, 2), k_new=k_new,
                                  v_new=v_new)
