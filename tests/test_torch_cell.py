"""The port's paged decode cell against ``repro.models.transformer``.

Both run ``decode_step_paged`` step after step on the same weights (the
reference's, carried across with ``params_from_numpy``), tokens, positions
and shuffled block tables, with one slot idle in NULL_BLOCK throughout and
another admitted mid-run.  Held: the logits of every live slot and every
pool row outside NULL_BLOCK, in f32 at rtol 1e-4, atol 1e-5.  Not bitwise:
the reference attends over the old cache and merges the new token with a
second softmax step, the port commits the new row first and attends once.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
RTOL, ATOL = 1e-4, 1e-5
B, MAX_LEN, BS, STEPS = 4, 32, 8, 12
LATE_SLOT, LATE_START, IDLE_SLOT = 2, 4, 3


def _schedule(seed):
    """Per-step (tokens, positions, block tables, live slots): slot 3 idle
    (all-null table row, position 0) throughout, slot 2 idle until step 4
    and then admitted at position 0; tables are a shuffled permutation of
    the pool's blocks."""
    rng = np.random.default_rng(seed)
    nb = MAX_LEN // BS
    perm = rng.permutation(np.arange(1, 1 + B * nb))
    tables = perm.reshape(B, nb).astype(np.int32)
    tables[IDLE_SLOT] = 0
    start = np.array([0, 0, LATE_START, 0])
    for step in range(STEPS):
        live = [b for b in range(B) if b != IDLE_SLOT and step >= start[b]]
        pos = np.array([step - start[b] if b in live else 0
                        for b in range(B)], np.int32)
        bt = tables.copy()
        bt[[b for b in range(B) if b not in live]] = 0
        tokens = rng.integers(0, 256, size=(B, 1)).astype(np.int32)
        yield tokens, pos, bt, live


@pytest.mark.parametrize("arch", ["gpt2-124m", "qwen3-1.7b"])
def test_decode_step_paged_matches_reference(arch):
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = port_configs.get_smoke_config(arch)
    ref_params = ref_steps.init_model(jax.random.PRNGKey(0), rcfg)
    params = transformer.params_from_numpy(
        jax.tree.map(np.asarray, ref_params), cfg, "cpu")
    ref_cache = ref_tf.init_paged_cache(rcfg, B, MAX_LEN, BS)
    cache = transformer.init_paged_cache(cfg, B, MAX_LEN, BS, "cpu")
    ref_step = jax.jit(lambda p, t, c, pos, bt: ref_tf.decode_step_paged(
        p, rcfg, t, c, pos, bt, block_size=BS))

    for tokens, pos, bt, live in _schedule(seed=1):
        want, ref_cache = ref_step(ref_params, tokens, ref_cache, pos, bt)
        got, cache = transformer.decode_step_paged(
            params, cfg, torch.from_numpy(tokens), cache,
            torch.from_numpy(pos), torch.from_numpy(bt), block_size=BS)
        assert got.shape == (B, 1, cfg.vocab_padded)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy()[live],
                                   np.asarray(want)[live],
                                   rtol=RTOL, atol=ATOL)
        for key in ("k", "v"):
            pool = np.asarray(ref_cache["blocks"]["slot0"][key])
            np.testing.assert_allclose(cache[key].numpy()[:, 1:],
                                       pool[:, 1:], rtol=RTOL, atol=ATOL)


def test_flat_index_routes_idle_slots_to_the_null_block():
    """A decode step's commit (a chunk of one) writes each slot's row at
    its position through its table; an idle slot's all-zero table row
    sends it into NULL_BLOCK."""
    from repro_torch.kernels.flash_decode import commit_paged

    bt = torch.tensor([[5, 9], [0, 0], [3, 7]], dtype=torch.int32)
    pos = torch.tensor([10, 0, 3], dtype=torch.int32)
    k_pool = torch.zeros(10, 8, 1, 16)
    v_pool = torch.zeros_like(k_pool)
    k_new = torch.arange(1.0, 4.0)[:, None, None, None].expand(3, 1, 1, 16)
    commit_paged(k_new.contiguous(), -k_new.contiguous(), k_pool, v_pool, bt,
                 pos, torch.ones_like(pos))
    rows = k_pool.reshape(80, 16)
    written = rows.abs().sum(1).nonzero().squeeze(1).tolist()
    want = [9 * 8 + 2, transformer.NULL_BLOCK * 8, 3 * 8 + 3]
    assert written == sorted(want)
    assert [rows[r, 0].item() for r in want] == [1.0, 2.0, 3.0]
    assert torch.equal(v_pool, -k_pool)


def test_paged_cache_layout_and_block_bytes():
    cfg = port_configs.get_smoke_config("qwen3-1.7b")
    rcfg = ref_configs.get_smoke_config("qwen3-1.7b")
    cache = transformer.init_paged_cache(cfg, 3, 32, 8, "cpu")
    ref_cache = ref_tf.init_paged_cache(rcfg, 3, 32, 8)
    assert tuple(cache["k"].shape) == \
        ref_cache["blocks"]["slot0"]["k"].shape
    assert not cache["k"].any() and not cache["v"].any()
    assert transformer.paged_block_bytes(cfg, 8) == \
        ref_tf.paged_block_bytes(rcfg, 8)
    with pytest.raises(ValueError):
        transformer.init_paged_cache(cfg, 3, 30, 8, "cpu")


def test_non_dense_archs_are_refused_with_their_roadmap_item():
    import dataclasses

    cfg = dataclasses.replace(port_configs.get_smoke_config("gpt2-124m"),
                              is_encoder_decoder=True)
    with pytest.raises(ValueError, match="1.18"):
        transformer.init_lm(cfg, device="cpu")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg = port_configs.get_smoke_config("gpt2-124m")
    with pytest.raises(RuntimeError, match="cuda"):
        transformer.init_lm(cfg)
