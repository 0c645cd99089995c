"""The host-side plans of the flash-decode and chunked-prefill kernels, and
the decode's split-and-merge against the reference.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py`` and
``chip_smoke.py``); what sizes their grids, shared memory and scratch is
Python, and is held here:

* the decode plan splits a slot's rows (``nb * bs`` paged, ``S``
  contiguous) into splits that cover every row once, are whole pool blocks
  (or contiguous tiles), and depend on neither the heads nor the batch, so
  a head slice splits its rows as the unsharded launch does;
* the prefill plan's key tiles are whole pool blocks, its query tile at
  most 64 vectors, its shared memory within an H100 block's 227 KB for
  every head shape the port serves and every (q, pool) pair, and it raises
  on a shape that does not fit;
* ``ref.decode_split_merge``, the plain model of the kernel's per-split
  (m, l, acc) and ordered merge, against the reference's ``decode_ref`` on
  the same numpy inputs at the fp32 tolerance (1e-5: the same softmax,
  summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_decode import ref as jref  # noqa: E402
from repro_torch.kernels.flash_decode import kernel, ref  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

#: (KV, G, D) of the served archs at full width, their smoke configs, the
#: registry's flash workloads, a head dim of 32 and G = 8 at D = 128
HEADS = [(12, 1, 64), (8, 2, 128), (4, 1, 16), (2, 2, 16), (2, 4, 16),
         (4, 2, 32), (1, 8, 128)]
BLOCK_SIZES = [1, 4, 8, 16, 32, 48, 64, 128, 512]


def _splits(plan, rows):
    return [range(z * plan.split_rows, min((z + 1) * plan.split_rows, rows))
            for z in range(plan.splits)]


@pytest.mark.parametrize("bs", BLOCK_SIZES)
@pytest.mark.parametrize("nb", [1, 3, 64])
def test_decode_splits_cover_every_paged_row_once(bs, nb):
    plan = kernel.decode_plan(nb * bs, bs, 8, 8, 2, 128)
    rows = [t for r in _splits(plan, nb * bs) for t in r]
    assert rows == list(range(nb * bs))
    assert all(len(r) > 0 for r in _splits(plan, nb * bs))


@pytest.mark.parametrize("S", [1, 63, 64, 255, 256, 257, 300, 4096])
def test_decode_splits_cover_every_contiguous_row_once(S):
    plan = kernel.decode_plan(S, kernel.DECODE_TILE, 32, 8, 2, 128)
    assert [t for r in _splits(plan, S) for t in r] == list(range(S))
    assert plan.split_rows % kernel.DECODE_TILE == 0


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_decode_split_is_whole_blocks(bs):
    L = kernel.decode_split_rows(bs)
    assert L % bs == 0 and L >= bs
    assert L <= max(kernel.DECODE_SPLIT, bs)
    assert L // bs <= 256  # the kernel's table of one split
    assert kernel.decode_split_rows(kernel.DECODE_TILE) % \
        kernel.DECODE_TILE == 0


@pytest.mark.parametrize("bs,nb", [(16, 64), (16, 256), (8, 5), (32, 3)])
def test_decode_split_does_not_depend_on_heads_or_batch(bs, nb):
    """Every KV (a head slice's local heads), G and B gets the same split
    rows and split count; only the scratch scales with them."""
    plans = {(B, KV, G): kernel.decode_plan(nb * bs, bs, B, KV, G, 128)
             for B in (1, 8, 32) for KV in (1, 2, 4, 8) for G in (1, 2, 8)}
    assert len({(p.split_rows, p.splits) for p in plans.values()}) == 1
    for (B, KV, G), p in plans.items():
        if p.splits == 1:
            assert (p.scratch_floats, p.counters) == (0, 0)
        else:
            assert p.scratch_floats == B * KV * G * p.splits * (128 + 2)
            assert p.counters == B * KV * G


@pytest.mark.parametrize("KV,G,D", HEADS)
@pytest.mark.parametrize("pair", kernel.POOL_PAIRS,
                         ids=lambda p: f"{p[0]}-{p[1]}".replace("torch.", ""))
@pytest.mark.parametrize("nb", [4, 64, 1024])
def test_prefill_plan_fits_the_shared_memory(KV, G, D, pair, nb):
    plan = kernel.prefill_plan(64, G, D, 16, nb, *pair)
    assert plan.smem <= kernel.SMEM_LIMIT
    assert plan.rows * G <= kernel.PREFILL_VECTORS
    assert plan.rows == min(64, kernel.PREFILL_VECTORS // G)
    assert plan.route == ("mma" if pair == (torch.bfloat16, torch.bfloat16)
                          else "simt")


@pytest.mark.parametrize("bs", BLOCK_SIZES)
def test_prefill_key_tiles_are_whole_pool_blocks(bs):
    kt = kernel.prefill_plan(64, 2, 128, bs, 8, torch.bfloat16,
                             torch.bfloat16).key_tile
    assert kt <= kernel.PREFILL_KEYS
    if bs <= kernel.PREFILL_KEYS:
        assert kt % bs == 0 and kt + bs > kernel.PREFILL_KEYS
    else:  # a block above 64 rows is walked in tiles of 64 of its rows
        assert kt == kernel.PREFILL_KEYS


def test_prefill_plan_rows_stop_at_the_chunk():
    assert kernel.prefill_plan(1, 2, 128, 16, 64, torch.float32,
                               torch.int8).rows == 1
    assert kernel.prefill_plan(11, 1, 64, 16, 8, torch.bfloat16,
                               torch.bfloat16).rows == 11
    assert kernel.prefill_plan(64, 3, 16, 16, 8, torch.float32,
                               torch.float32).rows == 21


@pytest.mark.parametrize("G,nb", [(65, 4), (2, 60000)])
def test_prefill_plan_raises_on_a_shape_that_does_not_fit(G, nb):
    with pytest.raises(ValueError, match="query vectors|shared memory"):
        kernel.prefill_plan(64, G, 128, 16, nb, torch.float32,
                            torch.bfloat16)


# -- the split-and-merge model against the reference ------------------------

L = kernel.decode_split_rows(16)


def _lengths(rows):
    return [1, L - 1, L, L + 1, rows]


@pytest.mark.parametrize("KV,G,D", [(2, 2, 16), (1, 3, 32), (2, 1, 64)])
def test_split_merge_matches_the_reference_decode(KV, G, D):
    """Contiguous cache of 24 blocks of 16 rows (two splits and a half):
    lengths 1, L - 1, L, L + 1 and every row."""
    S = 24 * 16
    lengths = _lengths(S)
    rng = np.random.default_rng(KV * 100 + G * 10 + D)
    q = rng.standard_normal((len(lengths), KV, G, D)).astype(np.float32)
    k, v = (rng.standard_normal((len(lengths), S, KV, D)).astype(np.float32)
            for _ in range(2))
    vl = np.array(lengths, dtype=np.int32)
    want = np.asarray(jref.decode_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jnp.asarray(vl)))
    got = ref.decode_split_merge(*(torch.from_numpy(x) for x in (q, k, v)),
                                 torch.from_numpy(vl), L)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_split_merge_matches_the_reference_paged_decode():
    """Pools of 16-row blocks through a shuffled table, gathered into each
    slot's view, then split and merged: the reference's paged oracle."""
    B, KV, G, D, bs, nb = 5, 2, 2, 16, 16, 24
    rng = np.random.default_rng(7)
    n_blocks = 1 + B * nb
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_blocks, bs, KV, D)).astype(np.float32)
              for _ in range(2))
    bt = rng.permutation(np.arange(1, n_blocks))[: B * nb].reshape(B, nb)
    bt = bt.astype(np.int32)
    vl = np.array(_lengths(nb * bs), dtype=np.int32)
    want = np.asarray(jref.decode_paged_ref(*(jnp.asarray(x) for x in
                                              (q, kp, vp, bt, vl))))
    idx = torch.from_numpy(bt).long()
    k = torch.from_numpy(kp)[idx].reshape(B, nb * bs, KV, D)
    v = torch.from_numpy(vp)[idx].reshape(B, nb * bs, KV, D)
    got = ref.decode_split_merge(torch.from_numpy(q), k, v,
                                 torch.from_numpy(vl), L)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_split_merge_gives_zeros_for_an_empty_contiguous_slot():
    """A slot of length 0 gives zeros (the kernel's clamped sum; the
    reference's oracle gives the mean of v there); the other slots still
    match the reference."""
    B, KV, G, D, S = 3, 2, 2, 16, 2 * L + 5
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
            for _ in range(2))
    vl = np.array([0, L + 1, S], dtype=np.int32)
    got = ref.decode_split_merge(*(torch.from_numpy(x) for x in (q, k, v)),
                                 torch.from_numpy(vl),
                                 kernel.decode_split_rows(kernel.DECODE_TILE))
    assert not got[0].any()
    want = np.asarray(jref.decode_ref(*(jnp.asarray(x) for x in
                                        (q, k, v, vl))))
    np.testing.assert_allclose(got[1:].numpy(), want[1:], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(got, ref.decode_plain(
        *(torch.from_numpy(x) for x in (q, k, v, vl))), rtol=1e-5, atol=1e-5)
