"""The port's paged flash-decode against the reference's.

On the CPU the wrapper runs its plain version (``ref.py``), which is held
against the JAX Pallas kernel in interpret mode and against the JAX oracle
``decode_paged_ref``, on shuffled block tables with ragged lengths.
Tolerances: plain vs oracle 1e-5 (both are fp32 gather + softmax, summed
in another order); vs the Pallas kernel 3e-5, the bound the reference's
own kernel tests use for its online softmax.  The CUDA kernel itself runs
only on the card (``chip_smoke.py`` and ``tests/test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels.flash_decode import kernel as ref_kernel  # noqa: E402
from repro.kernels.flash_decode import ref as ref_oracle  # noqa: E402
from repro_torch.kernels.flash_decode import kernel, ref  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)


def _paged_inputs(B, KV, G, D, bs, nb, seed=0):
    """numpy q, pools, shuffled non-contiguous block tables (block 0 =
    null) and ragged valid lengths including 1 and the full length."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * nb
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    k_pool = rng.standard_normal((n_blocks, bs, KV, D)).astype(np.float32)
    v_pool = rng.standard_normal((n_blocks, bs, KV, D)).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_blocks))[: B * nb].reshape(B, nb)
    valid = rng.integers(1, nb * bs + 1, size=B)
    valid[0] = 1
    valid[-1] = nb * bs
    return q, k_pool, v_pool, bt.astype(np.int32), valid.astype(np.int32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("B,KV,G,D,bs,nb", [
    (1, 1, 1, 16, 8, 4),
    (3, 2, 2, 16, 4, 6),
    (2, 4, 2, 32, 16, 2),
    (4, 12, 1, 64, 16, 3),   # gpt2-124m heads
    (2, 8, 2, 128, 16, 2),   # qwen3-1.7b heads
])
def test_plain_matches_pallas_kernel_and_oracle(B, KV, G, D, bs, nb):
    arrays = _paged_inputs(B, KV, G, D, bs, nb)
    out = kernel.flash_decode_paged(*_torch(*arrays)).numpy()
    jx = [jnp.asarray(a) for a in arrays]
    pallas = ref_kernel.flash_decode_paged(*jx, interpret=True)
    oracle = ref_oracle.decode_paged_ref(*jx)
    np.testing.assert_allclose(out, np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(out, np.asarray(pallas), rtol=3e-5,
                               atol=3e-5)


def test_plain_bf16_matches_oracle():
    """bf16 pools and q: the same gather + fp32 softmax, cast back; within
    one bf16 rounding of the JAX oracle on the same bf16 inputs."""
    q, kp, vp, bt, valid = _paged_inputs(3, 2, 2, 16, 8, 4, seed=2)
    bf = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, kp, vp)]
    out = kernel.flash_decode_paged(*bf, *_torch(bt, valid))
    assert out.dtype == torch.bfloat16
    jx = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in bf]
    want = ref_oracle.decode_paged_ref(*jx, jnp.asarray(bt),
                                       jnp.asarray(valid))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_stale_blocks_are_inert():
    """Garbage in rows at or past valid_len (recycled or never-allocated
    blocks) cannot reach the output."""
    B, KV, G, D, bs, nb = 2, 2, 2, 16, 4, 4
    q, kp, vp, bt, _ = _paged_inputs(B, KV, G, D, bs, nb, seed=5)
    valid = np.array([6, 11], np.int32)
    out1 = kernel.flash_decode_paged(*_torch(q, kp, vp, bt, valid))
    kp2, vp2 = kp.copy(), vp.copy()
    for b in range(B):
        for j in range(nb):
            for o in range(bs):
                if j * bs + o >= valid[b]:
                    kp2[bt[b, j], o] = 99.0
                    vp2[bt[b, j], o] = -99.0
    out2 = kernel.flash_decode_paged(*_torch(q, kp2, vp2, bt, valid))
    torch.testing.assert_close(out1, out2, rtol=1e-6, atol=1e-6)


def test_cpu_wrapper_leaves_the_launch_counter_at_zero():
    kernel.flash_decode_paged(*_torch(*_paged_inputs(2, 2, 1, 16, 4, 2)))
    assert kernel.flash_decode_paged.launches == 0


@pytest.mark.parametrize("bad", [
    "q_rank", "pool_shape", "pool_dtype", "table_dtype", "valid_shape",
    "non_contiguous", "float16",
])
def test_wrapper_rejects_malformed_inputs(bad):
    q, kp, vp, bt, valid = _torch(*_paged_inputs(2, 2, 2, 16, 4, 3))
    if bad == "q_rank":
        q = q[0]
    elif bad == "pool_shape":
        vp = vp[:, :2]
    elif bad == "pool_dtype":
        kp = kp.double()
    elif bad == "table_dtype":
        bt = bt.long()
    elif bad == "valid_shape":
        valid = valid[:1]
    elif bad == "non_contiguous":
        q = q.transpose(2, 3)
    elif bad == "float16":
        q, kp, vp = q.half(), kp.half(), vp.half()
    with pytest.raises((ValueError, TypeError)):
        kernel.flash_decode_paged(q, kp, vp, bt, valid)


def test_work_terms_count_each_input_once():
    """Bytes: q and output, the live K/V rows, the table entries they need
    and valid_len; flops: 4 per live row, head and element."""
    B, KV, G, D, bs, nb = 2, 3, 2, 64, 16, 4
    q = torch.zeros((B, KV, G, D), dtype=torch.bfloat16)
    k_pool = torch.zeros((1 + B * nb, bs, KV, D), dtype=torch.bfloat16)
    bt = torch.zeros((B, nb), dtype=torch.int32)
    t = ref.work_terms(q, k_pool, bt, [1, 17])
    live, tiles = 18, 1 + 2
    assert t["bytes"] == (2 * B * KV * G * D * 2 + 2 * live * KV * D * 2
                          + 4 * tiles + 4 * B)
    assert t["flops"] == 4.0 * live * KV * G * D
