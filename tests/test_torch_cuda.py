"""Tests of the port that need a CUDA card: the hand-written kernels have
no CPU mode.  Without a card every test here skips.

On a machine with the card (and without JAX, whose test fixtures
``tests/conftest.py`` loads), run them with:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package.  Tolerances:
bf16 2e-2 (one bf16 rounding of outputs of order 1), f32 1e-5 (the same
fp32 softmax summed in another order); the decode and chunk steps'
logits 1e-4, as the CPU parity tests hold the reference's.  A commit is a
copy, so committed pools are held bit for bit.
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


def _prefill_inputs(device, B, C, KV, G, D, bs, nb, dtype, seed=0, spare=2):
    """q, chunk K/V, pools with ``spare`` blocks no table names, a
    shuffled table, ragged q_start (0 and a block edge among them) and
    q_len (0, 1 and C among them), chunks crossing block edges."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * nb + spare
    shapes = [(B, C, KV, G, D), (B, C, KV, D), (B, C, KV, D),
              (n_blocks, bs, KV, D), (n_blocks, bs, KV, D)]
    arrays = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .to(device=device, dtype=dtype) for s in shapes]
    bt = rng.permutation(np.arange(1, n_blocks))[: B * nb].reshape(B, nb)
    q_len = rng.integers(0, C + 1, size=B)
    q_len[:3] = (0, 1, C)
    q_start = np.array([int(rng.integers(0, nb * bs - n + 1)) for n in q_len])
    q_start[:3] = (5, 0, bs)
    return arrays + [torch.from_numpy(a.astype(np.int32)).to(device)
                     for a in (bt, q_start, q_len)]


def _run_prefill(fn, args):
    """fn on private copies of the pools; returns (out, k_pool, v_pool)."""
    kp, vp = args[3].clone(), args[4].clone()
    out = fn(*args[:3], kp, vp, *args[5:])
    torch.cuda.synchronize()
    return out, kp, vp


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("KV,G,D", [(12, 1, 64), (8, 2, 128), (2, 8, 64)])
@pytest.mark.parametrize("C,bs,nb", [(11, 16, 8), (32, 8, 9), (5, 32, 3)])
def test_prefill_kernel_matches_plain(cuda, dtype, tol, KV, G, D, C, bs, nb):
    args = _prefill_inputs(cuda, 4, C, KV, G, D, bs, nb, dtype)
    before = kernel.flash_prefill_paged.launches
    out, kp, vp = _run_prefill(kernel.flash_prefill_paged, args)
    assert kernel.flash_prefill_paged.launches == before + 1
    want, kp_ref, vp_ref = _run_prefill(ref.flash_prefill_paged_ref, args)
    assert out.dtype == dtype and out.device == args[0].device
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    for b, n in enumerate(args[7].tolist()):
        assert not out[b, n:].any()
    assert torch.equal(kp, kp_ref) and torch.equal(vp, vp_ref)


def test_prefill_kernel_stale_and_foreign_blocks_are_inert(cuda):
    """Rows past each slot's chunk frontier never reach the output, and
    blocks no table names (the null block and spares) keep their bytes."""
    args = _prefill_inputs(cuda, 4, 12, 4, 2, 64, 16, 4, torch.float32,
                           seed=1)
    out1, kp1, vp1 = _run_prefill(kernel.flash_prefill_paged, args)
    bt, qs, ql = (a.tolist() for a in args[5:])
    kp2, vp2 = args[3].clone(), args[4].clone()
    for b in range(len(bt)):
        for p in range(qs[b] + ql[b], 4 * 16):
            kp2[bt[b][p // 16], p % 16] = 1e4
            vp2[bt[b][p // 16], p % 16] = float("nan")
    out2, _, _ = _run_prefill(kernel.flash_prefill_paged,
                              args[:3] + [kp2, vp2] + args[5:])
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
    named = {blk for row in bt for blk in row}
    for blk in range(args[3].shape[0]):
        if blk not in named:
            assert torch.equal(kp1[blk], args[3][blk])
            assert torch.equal(vp1[blk], args[4][blk])


def test_prefill_kernel_refuses_what_it_was_not_built_for(cuda):
    args = _prefill_inputs(cuda, 3, 4, 2, 1, 32, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_prefill_paged(*args)
    args = _prefill_inputs(cuda, 3, 4, 1, 1, 128, 128, 2, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.flash_prefill_paged(*args)
    args = _prefill_inputs(cuda, 3, 4, 2, 1, 64, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="one device"):
        kernel.flash_prefill_paged(*args[:7], args[7].cpu())


def test_prefill_step_on_the_card_matches_the_cpu(cuda):
    """A two-layer qwen3-1.7b cut (GQA 2, head_dim 128, qk-norm, f32):
    three chunk steps with ragged lengths (0, 1, chunks crossing blocks)
    on the card and on the CPU, then a decode step on the same pools."""
    cfg = dataclasses.replace(
        configs.get_config("qwen3-1.7b"), n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
        param_dtype="float32", compute_dtype="float32")
    steps = [([0, 0, 0, 0], [6, 3, 1, 0]), ([6, 3, 1, 0], [4, 0, 6, 0]),
             ([10, 3, 7, 0], [1, 2, 6, 0])]
    bt = torch.arange(1, 17, dtype=torch.int32).reshape(4, 4)
    bt[3] = 0
    rng = np.random.default_rng(5)
    tokens = [torch.from_numpy(rng.integers(0, cfg.vocab, (4, 8))
                               .astype(np.int32)) for _ in steps]
    got = {}
    for dev in ("cpu", "cuda"):
        params = transformer.init_lm(cfg, seed=3, device=dev)
        cache = transformer.init_paged_cache(cfg, 4, 64, 16, dev)
        rows = []
        for tok, (pos, lens) in zip(tokens, steps):
            lens = torch.tensor(lens, dtype=torch.int32)
            out, cache = transformer.prefill_step_paged(
                params, cfg, tok.to(dev), cache,
                torch.tensor(pos, dtype=torch.int32).to(dev), bt.to(dev),
                lens.to(dev), block_size=16)
            rows.append([out[b, :n].cpu() for b, n in
                         enumerate(lens.tolist())])
        out, cache = transformer.decode_step_paged(
            params, cfg, tokens[0][:, :1].to(dev), cache,
            torch.tensor([11, 5, 13, 0], dtype=torch.int32).to(dev),
            bt.to(dev), block_size=16)
        got[dev] = (rows, out[:3].cpu(), cache["k"][:, 1:].cpu(),
                    cache["v"][:, 1:].cpu())
    for step_cpu, step_cuda in zip(got["cpu"][0], got["cuda"][0]):
        for a, b in zip(step_cpu, step_cuda):
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
    for a, b in zip(got["cpu"][1:], got["cuda"][1:]):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4)
