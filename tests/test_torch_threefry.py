"""The port's threefry against ``jax.random``.

Keys, ``fold_in`` chains, the partitionable 32-bit draws and the uniforms
are integer or exactly rounded arithmetic and must be bit-equal; the
Gumbel noise goes through two logs, each within one ulp of the correctly
rounded value on either side, so it is held within 1e-6 absolute (one ulp
of the largest Gumbel a uniform in [tiny, 1) gives, 15.94); the
categorical draws must pick the same tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.serve import threefry  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

#: uid and index edge values, as uint32
EDGES = (0, 1, 2**31 - 1, 2**32 - 1)


def _jax_keys(seed, uids, idx):
    base = jax.random.PRNGKey(seed)
    return jax.vmap(lambda u, i: jax.random.fold_in(
        jax.random.fold_in(base, u), i))(jnp.asarray(uids, jnp.uint32),
                                         jnp.asarray(idx, jnp.uint32))


def _port_keys(seed, uids, idx):
    return threefry.fold_in(
        threefry.fold_in(threefry.prng_key(seed),
                         torch.tensor(np.asarray(uids, np.int64))),
        torch.tensor(np.asarray(idx, np.int64)))


def _words(key):
    return np.stack([key[0].numpy(), key[1].numpy()], -1)


def _cases(n, seed=0):
    """``n`` (uid, index) pairs: every pair of edge values, then random
    uint32 ones."""
    rng = np.random.default_rng(seed)
    pairs = [(u, i) for u in EDGES for i in EDGES]
    while len(pairs) < n:
        pairs.append(tuple(int(v) for v in rng.integers(0, 2**32, size=2)))
    uids, idx = zip(*pairs[:n])
    return list(uids), list(idx)


@pytest.mark.parametrize("seed", [0, 7, 42, 2**31 - 1])
def test_prng_key_and_fold_in_chains_are_bit_equal(seed):
    assert _words(threefry.prng_key(seed)).tolist() == \
        np.asarray(jax.random.PRNGKey(seed)).astype(np.int64).tolist()
    uids, idx = _cases(48, seed % 1000)
    want = np.asarray(_jax_keys(seed, uids, idx)).astype(np.int64)
    np.testing.assert_array_equal(_words(_port_keys(seed, uids, idx)), want)
    # a longer chain: fold the same key three more times
    jk, pk = _jax_keys(seed, uids, idx), _port_keys(seed, uids, idx)
    for d in (3, 2**32 - 1, 12345):
        jk = jax.vmap(lambda k: jax.random.fold_in(k, d))(jk)
        pk = threefry.fold_in(pk, torch.tensor(d))
    np.testing.assert_array_equal(_words(pk),
                                  np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("n", [1, 50_257])
def test_bits_and_uniforms_are_bit_equal(n):
    assert jax.config.jax_threefry_partitionable
    uids, idx = _cases(16, 1)
    jk, pk = _jax_keys(3, uids, idx), _port_keys(3, uids, idx)
    bits = jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(jk)
    np.testing.assert_array_equal(threefry.random_bits(pk, n).numpy(),
                                  np.asarray(bits).astype(np.int64))
    tiny = float(jnp.finfo(jnp.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0)):
        u = jax.vmap(lambda k: jax.random.uniform(
            k, (n,), jnp.float32, lo, hi))(jk)
        got = threefry.uniform(pk, n, lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(u).view(np.int32))


def test_gumbel_within_one_ulp():
    uids, idx = _cases(24, 2)
    jk, pk = _jax_keys(11, uids, idx), _port_keys(11, uids, idx)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (50_257,)))(jk))
    got = threefry.gumbel(pk, 50_257).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("vocab", [50_257, 151_936])
def test_categorical_picks_the_reference_tokens(vocab):
    """200 draws a vocab, in batches of 20, over random logits and (half of
    them) near-flat ones, where the Gumbel noise decides."""
    rng = np.random.default_rng(vocab)
    uids, idx = _cases(200, vocab)
    for lo in range(0, 200, 20):
        u, i = uids[lo:lo + 20], idx[lo:lo + 20]
        scale = 3.0 if lo < 100 else 1e-3
        logits = (scale * rng.standard_normal((20, vocab))).astype(np.float32)
        want = jax.vmap(jax.random.categorical)(_jax_keys(5, u, i),
                                                jnp.asarray(logits))
        got = threefry.categorical(_port_keys(5, u, i),
                                   torch.from_numpy(logits))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_works_on_batches_of_any_shape():
    key = threefry.fold_in(threefry.prng_key(1),
                           torch.arange(6, dtype=torch.int64).view(2, 3))
    assert threefry.random_bits(key, 5).shape == (2, 3, 5)
    assert threefry.categorical(key, torch.zeros(2, 3, 9)).shape == (2, 3)
