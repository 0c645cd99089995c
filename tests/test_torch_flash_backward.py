"""The port's flash-attention backward (``models/flash.py``: ``_Flash``, a
``torch.autograd.Function`` over ``_fwd_impl`` and ``_bwd_impl``) against
the reference's custom VJP, ``repro.models.flash.flash_attention`` under
``jax.grad``: the gradient cases of ``tests/test_flash_attention.py``
(causal and not) and more: GQA with G > 1, ``Dv != D`` (MLA's shape),
lengths that no tile divides (padded tails), cross-attention and
``q_offset``.  The same numpy inputs go through both; fp32 gradients are
held at the reference's rtol and atol 2e-4, bf16 ones at one bf16 ulp
(2**-7, rtol and atol).  The memory contract: the only tensors autograd
saves for the backward are q, k, v, out and lse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.flash import flash_attention as ref_flash  # noqa: E402
from repro_torch.models.flash import flash_attention  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

GRAD = dict(rtol=2e-4, atol=2e-4)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)

CASES = [
    # B, Sq, Sk, KV, G, D, Dv, causal, q_chunk, k_chunk, q_offset
    (1, 24, 24, 2, 2, 8, 8, True, 8, 8, 0),       # the reference's case
    (1, 24, 24, 2, 2, 8, 8, False, 8, 8, 0),      # ... not causal
    (2, 17, 17, 1, 4, 8, 8, True, 8, 4, 0),       # G 4, ragged q and k tails
    (1, 20, 20, 2, 3, 16, 24, True, 7, 6, 0),     # Dv != D, ragged tiles
    (1, 33, 64, 2, 1, 8, 12, False, 16, 16, 0),   # cross-attention, Dv != D
    (1, 8, 40, 1, 2, 16, 16, True, 8, 8, 32),     # q_offset: a later chunk
    (2, 16, 16, 4, 1, 24, 16, True, 16, 16, 0),   # one tile, MLA-like dims
]


def _mk(seed, B, Sq, Sk, KV, G, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, KV, G, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KV, Dv)).astype(np.float32))


def _grads(arrays, dtype, **kw):
    """(port, reference) gradients of sum(sin(out)) in q, k and v, fp32
    numpy."""
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32

    def loss(q, k, v):
        return jnp.sum(jnp.sin(ref_flash(q, k, v, **kw).astype(jnp.float32)))

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdtype) for a in arrays))
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in arrays]
    torch.sin(flash_attention(*ts, **kw).float()).sum().backward()
    for t, w in zip(ts, want):
        assert t.grad.dtype == dtype and tuple(t.grad.shape) == w.shape
    return ([t.grad.float().numpy() for t in ts],
            [np.asarray(w, np.float32) for w in want])


@pytest.mark.parametrize("B,Sq,Sk,KV,G,D,Dv,causal,qc,kc,qo", CASES)
def test_gradients_match_the_reference(B, Sq, Sk, KV, G, D, Dv, causal, qc,
                                       kc, qo):
    got, want = _grads(_mk(5, B, Sq, Sk, KV, G, D, Dv), torch.float32,
                       causal=causal, q_chunk=qc, k_chunk=kc, q_offset=qo)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **GRAD)


def test_bf16_gradients_match_the_reference():
    got, want = _grads(_mk(6, 2, 24, 24, 2, 2, 16, 16), torch.bfloat16,
                       causal=True, q_chunk=8, k_chunk=8)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **BF16)


def test_tiling_is_invisible_to_the_gradients():
    arrays = _mk(7, 1, 48, 48, 2, 2, 8, 8)
    base = _grads(arrays, torch.float32, causal=True, q_chunk=48,
                  k_chunk=48)[0]
    for qc, kc in ((8, 8), (16, 5), (7, 48)):
        got = _grads(arrays, torch.float32, causal=True, q_chunk=qc,
                     k_chunk=kc)[0]
        for g, b in zip(got, base):
            np.testing.assert_allclose(g, b, rtol=1e-5, atol=1e-6)


def test_backward_saves_only_q_k_v_out_and_lse():
    """The residual memory contract: the tensors autograd saves are q, k,
    v, out and lse, no (Sq, Sk) tile."""
    B, S, KV, G, D = 1, 32, 1, 2, 8
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _mk(8, B, S, S, KV, G, D, D))
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = flash_attention(q, k, v, causal=True, q_chunk=8, k_chunk=8)
    shapes = sorted(tuple(t.shape) for t in saved)
    assert shapes == sorted([(B, S, KV, G, D), (B, S, KV, D), (B, S, KV, D),
                             (B, S, KV, G, D), (B, S, KV, G)]), shapes
    assert any(t is q for t in saved) and any(t is v for t in saved)
    # the reference's bound: 3x slack over q+k+v+out+lse, far below tiles
    assert sum(t.numel() * t.element_size() for t in saved) \
        < 3 * (5 * S * G * D * 4)
    out.sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None


def test_kv_valid_len_is_forward_only():
    """Serving's ``kv_valid_len`` path keeps no autograd graph, as the
    reference's runs outside its custom VJP."""
    q, k, v = (torch.from_numpy(a) for a in _mk(9, 1, 8, 16, 1, 1, 8, 8))
    out = flash_attention(q.requires_grad_(), k, v, causal=False,
                          kv_valid_len=torch.tensor(10))
    assert out.grad_fn is None or "Flash" not in type(out.grad_fn).__name__
