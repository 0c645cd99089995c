"""The port's chunked online-softmax attention (``models/flash.py``)
against the reference's ``repro.models.flash.flash_attention``, on the
forward cases of ``tests/test_flash_attention.py``: causal and not, GQA,
ragged lengths that no chunk divides, cross-attention, ``q_offset``, and
``kv_valid_len`` with a poisoned tail.  The same inputs, drawn with
numpy, go through both; fp32 outputs are held at rtol 1e-5 and atol
1e-6, bf16 ones at one bf16 ulp (rtol 2**-7), the tiles' fp32 sums
landing on either side of a rounding.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.flash import flash_attention as ref_flash  # noqa: E402
from repro_torch.models.flash import _fwd_impl, flash_attention  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

F32 = dict(rtol=1e-5, atol=1e-6)


def _mk(seed, B, Sq, Sk, KV, G, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, KV, G, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32))


def _both(arrays, dtype=torch.float32, **kw):
    """(port, reference) outputs on the same inputs, as fp32 numpy."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    got = flash_attention(*(torch.from_numpy(a).to(dtype) for a in arrays),
                          **kw)
    want = ref_flash(*(jnp.asarray(a, jdtype) for a in arrays), **kw)
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    return got.float().numpy(), np.asarray(want, np.float32)


CASES = [
    # B, Sq, Sk, KV, G, D, causal, q_chunk, k_chunk
    (1, 16, 16, 1, 1, 8, True, 16, 16),
    (2, 32, 32, 2, 2, 16, True, 8, 8),
    (1, 17, 17, 1, 4, 8, True, 8, 4),     # ragged: not a chunk multiple
    (1, 33, 64, 2, 1, 8, False, 16, 16),  # cross-attention (Sq != Sk)
    (2, 8, 40, 1, 2, 16, False, 8, 8),
    (1, 64, 64, 4, 1, 8, True, 64, 64),   # single chunk (no tiling effects)
    (2, 20, 20, 2, 3, 16, True, 7, 6),    # ragged in both tile sizes
]


@pytest.mark.parametrize("B,Sq,Sk,KV,G,D,causal,qc,kc", CASES)
def test_forward_matches_the_reference(B, Sq, Sk, KV, G, D, causal, qc, kc):
    got, want = _both(_mk(0, B, Sq, Sk, KV, G, D), causal=causal,
                      q_chunk=qc, k_chunk=kc)
    np.testing.assert_allclose(got, want, **F32)


def test_bf16_matches_the_reference():
    got, want = _both(_mk(1, 2, 24, 24, 2, 2, 16), torch.bfloat16,
                      causal=True, q_chunk=8, k_chunk=8)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6)


@pytest.mark.parametrize("qc,kc", [(16, 8), (8, 16), (12, 48)])
def test_chunking_is_invisible(qc, kc):
    arrays = _mk(2, 1, 48, 48, 2, 2, 8)
    whole = flash_attention(*map(torch.from_numpy, arrays), causal=True,
                            q_chunk=48, k_chunk=48)
    tiled, want = _both(arrays, causal=True, q_chunk=qc, k_chunk=kc)
    np.testing.assert_allclose(tiled, whole.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tiled, want, **F32)


def test_q_offset_matches_the_reference():
    got, want = _both(_mk(3, 1, 4, 32, 1, 1, 8), causal=True, q_offset=28,
                      q_chunk=4, k_chunk=8)
    np.testing.assert_allclose(got, want, **F32)


def test_kv_valid_len_masks_a_poisoned_tail():
    q, k, v = _mk(4, 1, 8, 32, 1, 1, 8)
    got, want = _both((q, k, v), causal=False, k_chunk=8, kv_valid_len=20)
    np.testing.assert_allclose(got, want, **F32)
    k[:, 20:], v[:, 20:] = 100.0, -100.0
    poisoned = flash_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=False, k_chunk=8,
                               kv_valid_len=torch.tensor(20))
    np.testing.assert_allclose(poisoned.numpy(), got, rtol=1e-6, atol=1e-6)


def test_lse_is_the_log_of_the_softmax_sum():
    """``_fwd_impl``'s ``lse`` (kept for the train path's VJP): per query
    row, the log of the sum of exp(scores) over the visible keys."""
    q, k, v = map(torch.from_numpy, _mk(5, 1, 10, 10, 2, 2, 8))
    _, lse = _fwd_impl(q, k, v, causal=True, q_offset=0, q_chunk=4,
                       k_chunk=3, kv_valid_len=None)
    s = torch.einsum("bqkgd,bskd->bqkgs", q, k) / np.sqrt(8)
    mask = torch.ones(10, 10, dtype=torch.bool).tril()
    s = s.masked_fill(~mask[None, :, None, None, :], float("-inf"))
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-5, atol=1e-5)
