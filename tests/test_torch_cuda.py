"""Tests of the port that need a CUDA card: the hand-written kernel has no
CPU mode.  Without a card every test here skips.

On a machine with the card (and without JAX, whose test fixtures
``tests/conftest.py`` loads), run them with:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package.  Tolerances:
bf16 2e-2 (one bf16 rounding of outputs of order 1), f32 1e-5 (the same
fp32 softmax summed in another order); the decode step's logits 1e-4, as
the CPU parity tests hold the reference's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as configs  # noqa: E402
from repro_torch.kernels.flash_decode import kernel, ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(device, B, KV, G, D, bs, nb, dtype, seed=0):
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * nb
    shapes = [(B, KV, G, D), (n_blocks, bs, KV, D), (n_blocks, bs, KV, D)]
    q, kp, vp = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .to(device=device, dtype=dtype) for s in shapes]
    bt = rng.permutation(np.arange(1, n_blocks))[: B * nb].reshape(B, nb)
    valid = rng.integers(1, nb * bs + 1, size=B)
    valid[0], valid[-1] = 1, nb * bs
    return [q, kp, vp,
            torch.from_numpy(bt.astype(np.int32)).to(device),
            torch.from_numpy(valid.astype(np.int32)).to(device)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("KV,G,D", [(12, 1, 64), (8, 2, 128), (2, 8, 64)])
@pytest.mark.parametrize("bs,nb", [(16, 8), (8, 5), (32, 3)])
def test_kernel_matches_plain(cuda, dtype, tol, KV, G, D, bs, nb):
    args = _inputs(cuda, 4, KV, G, D, bs, nb, dtype)
    before = kernel.flash_decode_paged.launches
    out = kernel.flash_decode_paged(*args)
    torch.cuda.synchronize()
    assert kernel.flash_decode_paged.launches == before + 1
    assert out.dtype == dtype and out.device == args[0].device
    torch.testing.assert_close(out.float(),
                               ref.flash_decode_paged_ref(*args).float(),
                               rtol=tol, atol=tol)


def test_kernel_never_reads_rows_past_valid_len(cuda):
    args = _inputs(cuda, 3, 4, 2, 64, 16, 4, torch.float32, seed=1)
    q, kp, vp, bt, valid = args
    out1 = kernel.flash_decode_paged(*args)
    kp2, vp2 = kp.clone(), vp.clone()
    for b in range(bt.shape[0]):
        for t in range(int(valid[b]), bt.shape[1] * kp.shape[1]):
            blk, row = int(bt[b, t // kp.shape[1]]), t % kp.shape[1]
            kp2[blk, row] = 1e4
            vp2[blk, row] = float("nan")
    out2 = kernel.flash_decode_paged(q, kp2, vp2, bt, valid)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


def test_kernel_refuses_what_it_was_not_built_for(cuda):
    args = _inputs(cuda, 2, 2, 1, 32, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_decode_paged(*args)
    args = _inputs(cuda, 2, 2, 1, 64, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="one device"):
        kernel.flash_decode_paged(args[0], *args[1:4], args[4].cpu())


def test_decode_step_on_the_card_matches_the_cpu(cuda):
    """A two-layer gpt2 cut (head_dim 64, f32): the same step on the card
    and on the CPU."""
    cfg = dataclasses.replace(
        configs.get_config("gpt2-124m"), n_layers=2, d_model=128,
        n_heads=2, n_kv_heads=2, d_ff=256, vocab=512,
        param_dtype="float32", compute_dtype="float32")
    logits = {}
    for dev in ("cpu", "cuda"):
        params = transformer.init_lm(cfg, seed=3, device=dev)
        cache = transformer.init_paged_cache(cfg, 3, 64, 16, dev)
        bt = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4).to(dev)
        for t in range(20):
            tokens = torch.full((3, 1), 7 * t % cfg.vocab, dtype=torch.int32)
            pos = torch.full((3,), t, dtype=torch.int32)
            out, cache = transformer.decode_step_paged(
                params, cfg, tokens.to(dev), cache, pos.to(dev), bt,
                block_size=16)
        logits[dev] = out.cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4,
                               atol=1e-4)
