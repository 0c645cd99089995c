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
@pytest.mark.parametrize("KV,G,D", [(12, 1, 64), (8, 2, 128), (2, 8, 64),
                                    (4, 1, 16), (2, 4, 16), (4, 2, 32)])
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
    args = _inputs(cuda, 2, 2, 1, 48, 16, 2, torch.float32)
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


def test_init_drawn_on_the_card_is_seeded_and_keeps_the_law(cuda):
    """``init_lm(draw_device="cuda")``: the same seed gives the same
    numbers, each leaf the CPU draw's shape and dtype, matrices clipped at
    two standard deviations of their fan-in (moe experts and mamba
    mixers drawn by generators of their own on the card too)."""
    for arch in ("qwen3-1.7b", "deepseek-moe-16b", "mamba2-370m"):
        cfg = configs.get_smoke_config(arch)
        a, b = (transformer.init_lm(cfg, seed=5, device="cuda",
                                    draw_device="cuda") for _ in range(2))
        host = transformer.init_lm(cfg, seed=5, device="cpu")

        def leaves(tree, path=""):
            if isinstance(tree, dict):
                return [x for k, v in tree.items()
                        for x in leaves(v, f"{path}/{k}")]
            if isinstance(tree, list):
                return [x for i, v in enumerate(tree)
                        for x in leaves(v, f"{path}/{i}")]
            return [(path, tree)]

        drawn = 0
        for (path, x), (_, y), (_, h) in zip(leaves(a), leaves(b),
                                             leaves(host)):
            assert x.is_cuda and torch.equal(x, y), path
            assert (x.shape, x.dtype) == (h.shape, h.dtype), path
            h = h.float()
            if h.numel() >= 4096 and float(h.std()) > 0:  # a drawn matrix
                x = x.float().cpu()
                # the clip, 2 std of the fan-in, is the host draw's max
                assert float(x.abs().max()) <= float(h.abs().max()), path
                assert abs(float(x.std()) / float(h.std()) - 1) < 0.05, path
                drawn += 1
        assert drawn > 5, arch


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
@pytest.mark.parametrize("KV,G,D", [(12, 1, 64), (8, 2, 128), (2, 8, 64),
                                    (4, 1, 16), (2, 4, 16), (4, 2, 32)])
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
    args = _prefill_inputs(cuda, 3, 4, 2, 1, 48, 16, 2, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        kernel.flash_prefill_paged(*args)
    # a table row of 20000 blocks does not fit beside the fp32 tiles
    args = _prefill_inputs(cuda, 3, 4, 1, 1, 128, 1, 20000, torch.float32)
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


# -- quantized paging: int8 and bf16-under-f32 pools --------------------------
# Outputs at the pair's q tolerance (bf16 2e-2, f32 1e-5: the same
# dequantize-then-fp32-softmax arithmetic summed in another order);
# committed codes, scales and bf16 rows bit-equal to the plain commit.

PAIRS = [(q, p) for q, p in kernel.POOL_PAIRS if q != p]
Q_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _pools_as(device, kp, vp, pool_dtype):
    """(k_pool, v_pool, k_scale, v_scale) from f32 pools: quantized by the
    plain quantizer for int8 (scales then), else cast."""
    if pool_dtype != torch.int8:
        return kp.to(pool_dtype), vp.to(pool_dtype), None, None
    (kq, ks), (vq, vs) = ref.quantize_rows(kp), ref.quantize_rows(vp)
    return kq, vq, ks, vs


@pytest.mark.parametrize("q_dtype,pool_dtype", PAIRS)
@pytest.mark.parametrize("KV,G,D", [(12, 1, 64), (8, 2, 128), (2, 4, 16),
                                    (4, 2, 32)])
@pytest.mark.parametrize("bs,nb", [(16, 8), (8, 5)])
def test_quantized_decode_kernel_matches_plain(cuda, q_dtype, pool_dtype, KV,
                                               G, D, bs, nb):
    q, kp, vp, bt, valid = _inputs(cuda, 4, KV, G, D, bs, nb, torch.float32)
    args = [q.to(q_dtype), *_pools_as(cuda, kp, vp, pool_dtype)]
    before = kernel.flash_decode_paged.launches
    out = kernel.flash_decode_paged(args[0], args[1], args[2], bt, valid,
                                    args[3], args[4])
    torch.cuda.synchronize()
    assert kernel.flash_decode_paged.launches == before + 1
    assert out.dtype == q_dtype
    want = ref.flash_decode_paged_ref(args[0], args[1], args[2], bt, valid,
                                      args[3], args[4])
    tol = Q_TOL[q_dtype]
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


def test_int8_decode_kernel_never_reads_rows_or_scales_past_valid_len(cuda):
    q, kp, vp, bt, valid = _inputs(cuda, 3, 4, 2, 64, 16, 4, torch.float32,
                                   seed=1)
    kq, vq, ks, vs = _pools_as(cuda, kp, vp, torch.int8)
    out1 = kernel.flash_decode_paged(q, kq, vq, bt, valid, ks, vs)
    kq2, vq2, ks2, vs2 = kq.clone(), vq.clone(), ks.clone(), vs.clone()
    for b in range(bt.shape[0]):
        for t in range(int(valid[b]), bt.shape[1] * 16):
            blk, row = int(bt[b, t // 16]), t % 16
            kq2[blk, row], vq2[blk, row] = 127, -127
            ks2[blk, row], vs2[blk, row] = 1e4, float("nan")
    out2 = kernel.flash_decode_paged(q, kq2, vq2, bt, valid, ks2, vs2)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


def _quantized_prefill_args(device, q_dtype, pool_dtype, KV, G, D, C, bs,
                            nb, seed=0):
    args = _prefill_inputs(device, 4, C, KV, G, D, bs, nb, torch.float32,
                           seed=seed)
    kp, vp, ks, vs = _pools_as(device, args[3], args[4], pool_dtype)
    return ([a.to(q_dtype) for a in args[:3]] + [kp, vp] + args[5:],
            ks, vs)


def _run_quantized(fn, args, ks, vs):
    kp, vp = args[3].clone(), args[4].clone()
    scales = (ks.clone(), vs.clone()) if ks is not None else (None, None)
    out = fn(*args[:3], kp, vp, *args[5:], *scales)
    torch.cuda.synchronize()
    return out, kp, vp, scales


@pytest.mark.parametrize("q_dtype,pool_dtype", PAIRS)
@pytest.mark.parametrize("KV,G,D", [(12, 1, 64), (8, 2, 128), (2, 4, 16),
                                    (4, 2, 32)])
@pytest.mark.parametrize("C,bs,nb", [(11, 16, 8), (32, 8, 9)])
def test_quantized_prefill_kernel_matches_plain(cuda, q_dtype, pool_dtype,
                                                KV, G, D, C, bs, nb):
    args, ks, vs = _quantized_prefill_args(cuda, q_dtype, pool_dtype, KV, G,
                                           D, C, bs, nb)
    before = kernel.flash_prefill_paged.launches
    got = _run_quantized(kernel.flash_prefill_paged, args, ks, vs)
    assert kernel.flash_prefill_paged.launches == before + 1
    want = _run_quantized(ref.flash_prefill_paged_ref, args, ks, vs)
    tol = Q_TOL[q_dtype]
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=tol,
                               atol=tol)
    for b, n in enumerate(args[7].tolist()):
        assert not got[0][b, n:].any()
    # committed rows and scales bit-equal; unnamed blocks as they were
    for a, w in zip([got[1], got[2], *got[3]], [want[1], want[2], *want[3]]):
        if a is not None:
            assert torch.equal(a, w)
    named = set(args[5].reshape(-1).tolist())
    for blk in range(args[3].shape[0]):
        if blk not in named:
            assert torch.equal(got[1][blk], args[3][blk])
            if ks is not None:
                assert torch.equal(got[3][0][blk], ks[blk])


# -- the split decode and the tiled prefill at their edges -------------------
#
# The decode splits a slot's rows into splits of L rows (kernel.decode_plan)
# merged in a fixed order; the prefill walks key tiles of 64 rows up to each
# block's causal frontier.  Tolerances as above: bf16 q over bf16 pools
# 2e-2, every other pair 1e-5 plus one ulp of a bf16 output (fp32
# arithmetic summed in another order).

EDGE_HEADS = [(8, 2, 128), (12, 1, 64), (1, 8, 128), (2, 4, 16)]


def _close(got, want, q_dtype, pool_dtype):
    if (q_dtype, pool_dtype) == (torch.bfloat16, torch.bfloat16):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
        return
    tol = 1e-5 + 1e-5 * want.float().abs()
    if got.dtype == torch.bfloat16:
        tol = tol + (want.float().abs() * 2.0 ** -7).clamp(min=2.0 ** -133)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.parametrize("pair", kernel.POOL_PAIRS)
@pytest.mark.parametrize("KV,G,D", EDGE_HEADS)
@pytest.mark.parametrize("bs", [16, 8])
def test_decode_kernel_at_the_split_edges(cuda, pair, KV, G, D, bs):
    """valid_len L - 1, L, L + 1, nb * bs and 1 (one split, two, three)
    against the plain version and the plain split-and-merge model."""
    q_dtype, pool_dtype = pair
    L = kernel.decode_split_rows(bs)
    nb = (2 * L + L // 2) // bs
    q, kp, vp, bt, _ = _inputs(cuda, 5, KV, G, D, bs, nb, torch.float32,
                               seed=4)
    valid = torch.tensor([L - 1, L, L + 1, nb * bs, 1], dtype=torch.int32,
                         device=cuda)
    pools = _pools_as(cuda, kp, vp, pool_dtype)
    args = (q.to(q_dtype), pools[0], pools[1], bt, valid, *pools[2:])
    out = kernel.flash_decode_paged(*args)
    torch.cuda.synchronize()
    _close(out, ref.flash_decode_paged_ref(*args), *pair)
    if pool_dtype != torch.int8:
        idx = bt.long()
        k = pools[0][idx].reshape(5, nb * bs, KV, D)
        v = pools[1][idx].reshape(5, nb * bs, KV, D)
        _close(out, ref.decode_split_merge(args[0], k, v, valid, L), *pair)
    # a second launch on the same scratch gives the same bits
    assert torch.equal(out, kernel.flash_decode_paged(*args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,D", EDGE_HEADS)
def test_dense_decode_kernel_at_the_split_edges(cuda, dtype, KV, G, D):
    L = kernel.decode_split_rows(kernel.DECODE_TILE)
    S = 2 * L + 40
    q, k, v, _ = _dense_inputs(cuda, 6, KV, G, D, S, dtype, seed=5)
    valid = torch.tensor([L - 1, L, L + 1, S, 0, 1], dtype=torch.int32,
                         device=cuda)
    out = kernel.flash_decode(q, k, v, valid, block_s=S)
    torch.cuda.synchronize()
    assert not out[4].any()
    _close(out, kernel.flash_decode_plain(q, k, v, valid, block_s=S), dtype,
           dtype)
    _close(out, ref.decode_split_merge(q, k, v, valid, L), dtype, dtype)


@pytest.mark.parametrize("pair", kernel.POOL_PAIRS)
@pytest.mark.parametrize("KV,G,D", EDGE_HEADS)
def test_prefill_kernel_frontier_inside_a_tile_and_past_the_table(
        cuda, pair, KV, G, D):
    """Chunks whose causal frontier falls inside a 64-key tile (70 + 11),
    on a tile edge (48 + 16), at the table's end (80 + 16 of 96 rows), and
    a chunk whose padded rows run past the table's end (90 + 6, C = 16);
    the rows and scales past each frontier are then poisoned, which leaves
    the output bit-identical."""
    q_dtype, pool_dtype = pair
    C, bs, nb = 16, 16, 6
    args, ks, vs = _quantized_prefill_args(cuda, q_dtype, pool_dtype, KV, G,
                                           D, C, bs, nb, seed=6)
    args = args[:6] + [torch.tensor(x, dtype=torch.int32, device=cuda)
                       for x in ([70, 48, 80, 90], [11, 16, 16, 6])]
    got = _run_quantized(kernel.flash_prefill_paged, args, ks, vs)
    want = _run_quantized(ref.flash_prefill_paged_ref, args, ks, vs)
    valid = (torch.arange(C, device=cuda)[None, :] < args[7][:, None])
    _close(got[0][valid], want[0][valid], *pair)
    assert not got[0][~valid].any()
    bt, first = args[5], args[6] + args[7]
    pools = [got[1], got[2], *got[3]]
    pos = torch.arange(nb * bs, device=cuda)
    mask = pos[None, :] >= first.long()[:, None]
    blk, row = bt.long()[:, pos // bs][mask], (pos % bs)[None, :].expand_as(
        mask)[mask]
    bad = [None if t is None else t.clone() for t in pools]
    for t, value in zip(bad, (1e4, float("nan"), 1e4, float("nan"))):
        if t is not None:
            t[blk, row] = ((127 if value == 1e4 else -127)
                           if t.dtype == torch.int8 else value)
    again = _run_quantized(kernel.flash_prefill_paged,
                           args[:3] + bad[:2] + args[5:], *bad[2:])
    assert torch.equal(again[0], got[0])


@pytest.mark.parametrize("pair", kernel.POOL_PAIRS)
@pytest.mark.parametrize("n", [2, 4])
def test_head_slices_equal_the_unsharded_split_launch(cuda, pair, n):
    """Slots of several splits (lengths 1 .. nb * bs): the slices (i, n),
    concatenated, bit-equal to the unsharded launch."""
    q_dtype, pool_dtype = pair
    bs, nb = 16, 40
    q, kp, vp, bt, _ = _inputs(cuda, 6, 8, 2, 128, bs, nb, torch.float32,
                               seed=8)
    L = kernel.decode_split_rows(bs)
    valid = torch.tensor([1, L - 1, L + 1, 2 * L, 2 * L + 7, nb * bs],
                         dtype=torch.int32, device=cuda)
    pools = _pools_as(cuda, kp, vp, pool_dtype)
    args = (q.to(q_dtype), pools[0], pools[1], bt, valid, *pools[2:])
    full = kernel.flash_decode_paged(*args)
    parts = [kernel.flash_decode_paged(*args, head_shard=(i, n))
             for i in range(n)]
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=1), full)


@pytest.mark.parametrize("q_dtype,pool_dtype", PAIRS)
def test_commit_kernel_alone_matches_plain(cuda, q_dtype, pool_dtype):
    """The decode step's commit: a chunk of one row per slot, through the
    commit kernel alone."""
    args, ks, vs = _quantized_prefill_args(cuda, q_dtype, pool_dtype, 8, 2,
                                           128, 1, 16, 4, seed=2)
    results = []
    for fn, counter in ((kernel.commit_paged, True),
                        (ref.commit_paged_ref, False)):
        before = kernel.commit_paged.launches
        kp, vp = args[3].clone(), args[4].clone()
        scales = (ks.clone(), vs.clone()) if ks is not None else (None,
                                                                   None)
        fn(args[1], args[2], kp, vp, *args[5:], *scales)
        torch.cuda.synchronize()
        assert kernel.commit_paged.launches == before + counter
        results.append([kp, vp, *scales])
    for a, w in zip(*results):
        if a is not None:
            assert torch.equal(a, w)


def _fused_and_pair(q, pools, bt, vl, k_new, v_new, **slice_kw):
    """The decode that commits its rows, and the commit kernel then the
    decode, each on its own copy of the pools: (outputs, pools)."""
    fused = [None if t is None else t.clone() for t in pools]
    pair = [None if t is None else t.clone() for t in pools]
    got = kernel.flash_decode_paged(q, fused[0], fused[1], bt, vl,
                                    *fused[2:], k_new=k_new, v_new=v_new)
    kernel.commit_paged(k_new[:, None], v_new[:, None], pair[0], pair[1],
                        bt, vl - 1, torch.ones_like(vl), *pair[2:])
    want = kernel.flash_decode_paged(q, pair[0], pair[1], bt, vl, *pair[2:])
    torch.cuda.synchronize()
    return (got, want), (fused, pair)


@pytest.mark.parametrize("pair", kernel.POOL_PAIRS)
@pytest.mark.parametrize("KV,G,D", [(12, 1, 64), (8, 2, 128), (2, 4, 16),
                                    (4, 2, 32), (2, 8, 64)])
@pytest.mark.parametrize("bs,nb", [(16, 4), (16, 40), (8, 5)])
def test_fused_commit_decode_is_the_two_launch_pair(cuda, pair, KV, G, D, bs,
                                                    nb):
    """One decode launch given the slots' new rows equals the commit kernel
    then the decode bit for bit (output, pools, scales), with lengths of
    one row, at block and split edges and of the whole table; then the
    head slices (i, 2) given their heads of the rows (and the rows' amax
    for int8), concatenated, against the same pair."""
    q_dtype, pool_dtype = pair
    q, kp, vp, bt, _ = _inputs(cuda, 6, KV, G, D, bs, nb, torch.float32,
                               seed=KV + D)
    split = kernel.decode_split_rows(bs)
    vl = torch.tensor([min(n, nb * bs) for n in (1, bs, bs + 1, split,
                                                  split + 1, nb * bs)],
                      dtype=torch.int32, device=cuda)
    pools = _pools_as(cuda, kp, vp, pool_dtype)
    g = torch.Generator(device=cuda).manual_seed(D)
    k_new, v_new = (torch.randn((6, KV, D), device=cuda, generator=g)
                    .to(q_dtype) for _ in range(2))
    q = q.to(q_dtype)
    before = (kernel.flash_decode_paged.commit_launches,
              kernel.commit_paged.launches)
    (got, want), (fused, paired) = _fused_and_pair(q, pools, bt, vl, k_new,
                                                   v_new)
    assert (kernel.flash_decode_paged.commit_launches,
            kernel.commit_paged.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
    for a, w in zip(fused, paired):
        if a is not None:
            assert torch.equal(a, w)
    if KV % 2:
        return
    amax = {}
    if pool_dtype == torch.int8:
        amax = dict(k_amax=ref.row_amax(k_new), v_amax=ref.row_amax(v_new))
    sliced = [None if t is None else t.clone() for t in pools]
    parts = []
    for i in range(2):
        h = ref.head_slice((i, 2), KV)
        parts.append(kernel.flash_decode_paged(
            q, sliced[0], sliced[1], bt, vl, *sliced[2:], head_shard=(i, 2),
            k_new=k_new[:, h].contiguous(), v_new=v_new[:, h].contiguous(),
            **amax))
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts, dim=1), want)
    for a, w in zip(sliced, paired):
        if a is not None:
            assert torch.equal(a, w)


def test_fused_commit_refuses_what_it_was_not_built_for(cuda):
    q, kp, vp, bt, vl = _inputs(cuda, 2, 4, 2, 64, 16, 4, torch.float32)
    kq, vq, ks, vs = _pools_as(cuda, kp, vp, torch.int8)
    k_new = torch.zeros((2, 4, 64), device=cuda)
    h = ref.head_slice((0, 2), 4)
    with pytest.raises(ValueError, match="head_shard need k_amax"):
        kernel.flash_decode_paged(q, kq, vq, bt, vl, ks, vs,
                                  head_shard=(0, 2),
                                  k_new=k_new[:, h].contiguous(),
                                  v_new=k_new[:, h].contiguous())
    with pytest.raises(ValueError, match="contiguous on cuda"):
        kernel.flash_decode_paged(q, kq, vq, bt, vl, ks, vs,
                                  k_new=k_new.cpu(), v_new=k_new)


def _fused_commit_on_ranks(mesh, seed):
    """One rank of a 1 x M mesh on the card: the int8 decode that commits
    its heads of every slot's new row, each row's amax the MAX over
    ``model`` of the local ones, as the mesh engine calls it.  Returns
    every rank's output, pools and scales as numpy."""
    import torch.distributed as dist

    B, KV, G, D, bs, nb = 4, 4, 2, 64, 16, 6
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * nb
    q, kp, vp, k_new, v_new = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
        for s in ((B, KV, G, D), (n_blocks, bs, KV, D), (n_blocks, bs, KV, D),
                  (B, KV, D), (B, KV, D)))
    (kq, ks), (vq, vs) = ref.quantize_rows(kp), ref.quantize_rows(vp)
    bt = torch.from_numpy(rng.permutation(np.arange(1, n_blocks))[:B * nb]
                          .reshape(B, nb).astype(np.int32)).cuda()
    vl = torch.tensor([1, bs, bs + 1, nb * bs], dtype=torch.int32).cuda()
    h = ref.head_slice((mesh.model_index, mesh.model), KV)
    loc = [t[:, h].contiguous() for t in (q, k_new, v_new)]
    kl, vl_pool = (t[:, :, h].contiguous() for t in (kq, vq))
    out = kernel.flash_decode_paged_sharded(
        loc[0], kl, vl_pool, bt, vl, mesh=mesh, k_scale=ks, v_scale=vs,
        k_new=loc[1], v_new=loc[2],
        k_amax=mesh.max(ref.row_amax(loc[1]), "model"),
        v_amax=mesh.max(ref.row_amax(loc[2]), "model"))
    torch.cuda.synchronize()
    ranks = [None] * mesh.size
    dist.all_gather_object(ranks, [t.cpu().numpy()
                                   for t in (out, kl, vl_pool, ks, vs)])
    return ranks


def test_fused_commit_over_gloo_ranks_is_the_unsharded_pair(cuda):
    """Two ranks on the card over gloo, each committing and attending its
    heads with the rows' amax all-reduced: every rank's output, pools and
    scales are the unsharded pair's head slice."""
    from repro_torch.launch import mesh as mesh_mod

    got = mesh_mod.spawn(_fused_commit_on_ranks, 1, 2, 5, device="cuda",
                         timeout=300)
    B, KV, G, D, bs, nb = 4, 4, 2, 64, 16, 6
    rng = np.random.default_rng(5)
    n_blocks = 1 + B * nb
    q, kp, vp, k_new, v_new = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).cuda()
        for s in ((B, KV, G, D), (n_blocks, bs, KV, D), (n_blocks, bs, KV, D),
                  (B, KV, D), (B, KV, D)))
    (kq, ks), (vq, vs) = ref.quantize_rows(kp), ref.quantize_rows(vp)
    pools = [kq, vq, ks, vs]
    bt = torch.from_numpy(rng.permutation(np.arange(1, n_blocks))[:B * nb]
                          .reshape(B, nb).astype(np.int32)).cuda()
    vl = torch.tensor([1, bs, bs + 1, nb * bs], dtype=torch.int32).cuda()
    (_, want), (_, paired) = _fused_and_pair(q, pools, bt, vl, k_new, v_new)
    for m, (out, kl, vl_pool, ks, vs) in enumerate(got):
        h = ref.head_slice((m, 2), KV)
        np.testing.assert_array_equal(out, want[:, h].cpu().numpy())
        np.testing.assert_array_equal(kl, paired[0][:, :, h].cpu().numpy())
        np.testing.assert_array_equal(vl_pool,
                                      paired[1][:, :, h].cpu().numpy())
        np.testing.assert_array_equal(ks, paired[2].cpu().numpy())
        np.testing.assert_array_equal(vs, paired[3].cpu().numpy())


def test_quantized_serving_on_the_card_matches_the_cpu(cuda):
    """A two-layer qwen3-1.7b cut (GQA 2, head_dim 128, f32) with int8
    pools: teacher-forced decode and one chunk on the card within the
    reference's qwen3 int8 budget (0.11) of the CPU, and the engine with
    sharing on gives the streams of sharing off, both kernels launched."""
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = dataclasses.replace(
        configs.get_config("qwen3-1.7b"), n_layers=2, d_model=256,
        n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
        param_dtype="float32", compute_dtype="float32")
    rng = np.random.default_rng(6)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (3, 14))
                            .astype(np.int32))
    got = {}
    for dev in ("cpu", "cuda"):
        params = transformer.init_lm(cfg, seed=3, device=dev)
        bt = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4).to(dev)
        cache = transformer.init_paged_cache(cfg, 3, 64, 16, dev,
                                             kv_dtype="int8")
        rows = []
        for t in range(14):
            out, cache = transformer.decode_step_paged(
                params, cfg, toks[:, t:t + 1].to(dev), cache,
                torch.full((3,), t, dtype=torch.int32).to(dev), bt,
                block_size=16, kv_dtype="int8")
            rows.append(out.cpu())
        cache = transformer.init_paged_cache(cfg, 3, 64, 16, dev,
                                             kv_dtype="int8")
        chunk, _ = transformer.prefill_step_paged(
            params, cfg, toks.to(dev), cache,
            torch.zeros(3, dtype=torch.int32).to(dev), bt,
            torch.full((3,), 14, dtype=torch.int32).to(dev), block_size=16,
            kv_dtype="int8")
        got[dev] = (torch.cat(rows, 1), chunk.cpu())
    for a, b in zip(got["cpu"], got["cuda"]):
        assert (a - b).abs().max().item() <= 0.11

    params = transformer.init_lm(cfg, seed=3, device="cuda")
    prefix = rng.integers(0, cfg.vocab, 40).astype(np.int32)
    prompts = [np.concatenate([prefix, rng.integers(0, cfg.vocab, n)
                               .astype(np.int32)]) for n in (3, 9, 1, 5)]
    streams = {}
    for share in (False, True):
        eng = ServeEngine(cfg, params, max_batch=4, max_len=64,
                          block_size=16, prefill_chunk=8, kv_dtype="int8",
                          share_prefixes=share, device="cuda")
        for uid, p in enumerate(prompts):
            eng.submit(Request(uid=uid, prompt=p, max_new_tokens=6))
        counts = (kernel.flash_decode_paged.launches,
                  kernel.flash_prefill_paged.launches,
                  kernel.flash_decode_paged.commit_launches)
        eng.run_until_drained()
        torch.cuda.synchronize()
        assert kernel.flash_decode_paged.launches > counts[0]
        assert kernel.flash_prefill_paged.launches > counts[1]
        # every decode launch commits its step's rows (int8 pools)
        assert (kernel.flash_decode_paged.commit_launches - counts[2]
                == kernel.flash_decode_paged.launches - counts[0])
        streams[share] = [eng.completed[u].generated for u in range(4)]
        if share:
            assert eng.stats()["block_dedup_ratio"] > 1.0
    assert streams[True] == streams[False]


# -- the HPC kernels (STREAM, Jacobi2D, GEMM, SpMV) -----------------------------
# Tolerances are chip_smoke.py's: STREAM and Jacobi2D fp32 bit-equal and
# 16-bit one ulp; GEMM 1e-5 * max|plain| (+ one ulp in bf16); SpMV 1e-6 of
# each row's sum of |terms| + rtol 1e-5 (fp32) or one ulp (bf16).

import chip_smoke  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.gemm import kernel as gemm_kernel  # noqa: E402
from repro_torch.kernels.spmv import ref as spmv_ref  # noqa: E402


def _randn(device, shape, dtype, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, device=device, generator=g).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("rows,width,offset", [(64, 128, 0), (37, 100, 0),
                                               (37, 100, 1), (4099, 128, 0),
                                               (2049, 256, 3)])
@pytest.mark.parametrize("name,n_in,q", [("stream-copy", 1, None),
                                         ("stream-scale", 1, 0.3),
                                         ("stream-add", 2, None),
                                         ("stream-triad", 2, 0.3)])
def test_stream_kernel_matches_plain(cuda, dtype, rows, width, offset, name,
                                     n_in, q):
    n = rows * width
    arrays = [_randn(cuda, (n + offset,), dtype, s)[offset:].view(rows, width)
              for s in range(n_in)]
    args = arrays + ([q] if q is not None else [])
    ops = registry.get_kernel(name)
    before = ops.raw.launches
    got = ops.kernel(*args, block_rows=rows)
    torch.cuda.synchronize()
    assert ops.raw.launches == before + 1
    _, ok, _ = chip_smoke.exact_close(torch, got,
                                      ops.interpret(*args, block_rows=rows))
    assert ok and got.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,W", [(1, 5), (2, 7), (7, 2), (67, 1001),
                                 (300, 129)])
def test_jacobi_kernel_matches_plain(cuda, dtype, H, W):
    u = _randn(cuda, (H, W), dtype, 1)
    got = registry.JACOBI_STEP.kernel(u, block_rows=H)
    _, ok, _ = chip_smoke.exact_close(
        torch, got, registry.JACOBI_STEP.interpret(u, block_rows=H))
    assert ok
    torch.testing.assert_close(got[[0, -1]], u[[0, -1]], rtol=0, atol=0)


#: chip_smoke.py's GEMM cases: the wgmma route at its edges (M and N past
#: whole tiles, K = 8, K % 64 != 0, 1024 x 1024 x 4096, a shape inside one
#: tile) and the simt route (fp32, K not a multiple of its 16-deep slices,
#: bf16 that TMA cannot address, a misaligned A)
GEMM_SHAPES = [(dtype, offset, M, N, K)
               for dtype, offset, shapes in chip_smoke.GEMM_CASES
               for M, N, K in shapes]


@pytest.mark.parametrize("dtype,offset,M,N,K", GEMM_SHAPES)
def test_gemm_kernel_matches_plain(cuda, dtype, offset, M, N, K):
    x = _randn(cuda, (M * K + offset,), getattr(torch, dtype), 2)[offset:]
    x, y = x.view(M, K), _randn(cuda, (K, N), getattr(torch, dtype), 3)
    before = dict(gemm_kernel.gemm.route_launches)
    got = registry.GEMM.kernel(x, y, bm=M, bn=N, bk=K)
    err, ok = chip_smoke.gemm_close(
        torch, got, registry.GEMM.interpret(x, y, bm=M, bn=N, bk=K))
    assert ok, err
    assert chip_smoke.gemm_route(gemm_kernel, before) == \
        chip_smoke.gemm_expected_route(dtype, N, K, offset)


def test_gemm_wgmma_tile_reads_a_k_major_and_b_mn_major(cuda):
    """One 128 x 256 tile, K = 64, against stacked identities: with A = I,
    C is B's rows (each C[m][n] names the k and n it came from); with
    B = I, C is A's columns.  bf16 holds these small integers exactly, so
    a wrong descriptor offset or swizzle shows as wrong elements."""
    M, K, N, bf16 = 128, 64, 256, torch.bfloat16
    m = torch.arange(M, device=cuda)[:, None]
    k = torch.arange(K, device=cuda)
    n = torch.arange(N, device=cuda)[None, :]
    eye_a = (k[None, :] == m % K).to(bf16)
    eye_b = (n % K == k[:, None]).to(bf16)
    cases = [(eye_a, k[:, None].expand(K, N), (m % K).expand(M, N)),
             (eye_a, n.expand(K, N), n.expand(M, N)),
             (m.expand(M, K), eye_b, m.expand(M, N)),
             (k[None, :].expand(M, K), eye_b, (n % K).expand(M, N))]
    assert gemm_kernel.gemm_plan(M, N, K, bf16).route == "wgmma"
    for x, y, want in cases:
        got = gemm_kernel.gemm(x.to(bf16).contiguous(),
                               y.to(bf16).contiguous())
        torch.testing.assert_close(got, want.to(bf16), rtol=0, atol=0)


def test_gemm_counts_launches_by_route(cuda):
    fn = gemm_kernel.gemm
    bf = _randn(cuda, (64 * 72 + 1,), torch.bfloat16, 4)
    calls = [(bf[:64 * 72].view(64, 72), "wgmma"),
             (bf[1:].view(64, 72), "simt"),  # 2 bytes off a 16-byte line
             (bf[:64 * 72].view(64, 72).float(), "simt")]
    for x, route in calls:
        y = _randn(cuda, (72, 40), x.dtype, 5)
        before, total = dict(fn.route_launches), fn.launches
        fn(x, y)
        assert fn.launches == total + 1
        assert {r: n - before[r] for r, n in fn.route_launches.items()} == \
            {r: int(r == route) for r in gemm_kernel.ROUTES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("repeat", [1, 4, 20])
def test_spmv_kernels_match_plain(cuda, dtype, repeat):
    g = torch.Generator(device=cuda).manual_seed(4)
    vals, cols, nnz = spmv_ref.make_problem(
        1000, 3000, dtype=dtype, generator=g, device=cuda)
    nnz[0, :3] = torch.tensor([0, 1, 128], dtype=torch.int32)
    vals[0, 0] = 0
    vals[0, 1, 1:] = 0
    x = _randn(cuda, (3000,), dtype, 5)
    args = (vals, cols, nnz, x)
    got = registry.SPMV.kernel(*args, repeat=repeat)
    err, ok = chip_smoke.spmv_close(
        torch, got, registry.SPMV.interpret(*args, repeat=repeat),
        chip_smoke.spmv_scale(spmv_ref, *args, repeat=repeat))
    assert ok, err
    assert got[0].item() == 0.0
    fixed = registry.SPMV_FIXED.kernel(*args)
    err, ok = chip_smoke.spmv_close(
        torch, fixed, registry.SPMV_FIXED.interpret(*args),
        chip_smoke.spmv_scale(spmv_ref, *args, predicated=False))
    assert ok, err
    if repeat == 1:  # the plan's edge widths, row_nnz edges, misaligned
        from repro_torch.kernels.spmv import kernel as spmv_kernel

        cases = chip_smoke.spmv_edge_cases(torch, spmv_kernel, spmv_ref,
                                           dtype, g)
        assert {c["width"] for c in cases} == set(
            chip_smoke.SPMV_EDGE_WIDTHS)
        assert {c["plan"]["vec"] for c in cases} == {1, 16 // dtype.itemsize}
        assert all(c["ok"] for c in cases), [c for c in cases
                                             if not c["ok"]]


def test_hpc_kernels_refuse_what_they_were_not_built_for(cuda):
    a = torch.ones((8, 128), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        registry.STREAM_COPY(a)
    with pytest.raises(ValueError, match="one device"):
        registry.STREAM_ADD(a.float(), a.float().cpu())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        registry.GEMM.kernel(torch.ones(4, 4), torch.ones(4, 4))


def test_analysis_times_the_roi_on_the_card(cuda):
    from repro_torch.analysis import analyze
    from repro_torch.core import hw
    from repro_torch.kernels.gemm import kernel as gemm_kernel

    before = gemm_kernel.gemm.launches
    r = analyze("kernel/gemm", hw.H100, time_roi=True, device="cuda")
    assert r.wall_s > 0 and gemm_kernel.gemm.launches == before + 2


# -- the contiguous flash-decode and the RX gate --------------------------------
# Tolerances: flash-decode as the paged kernel's (bf16 2e-2, f32 1e-5); the
# RX gate bit-equal to its plain version (both round every operation to
# the planes' dtype).

from repro_torch.kernels.flash_decode import kernel as fd_kernel  # noqa: E402
from repro_torch.kernels.qc_gate import kernel as qc_kernel  # noqa: E402
from repro_torch.kernels.qc_gate import ops as qc_ops  # noqa: E402


def _dense_inputs(device, B, KV, G, D, S, dtype, seed=0):
    """q, k, v and ragged lengths with 0, 1, S and a tile edge among them."""
    rng = np.random.default_rng(seed)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(device=device, dtype=dtype)
               for s in ((B, KV, G, D), (B, S, KV, D), (B, S, KV, D))]
    valid = rng.integers(1, S + 1, size=B)
    valid[:4] = (0, 1, S, fd_kernel.DECODE_TILE)
    return [q, k, v, torch.from_numpy(valid.astype(np.int32)).to(device)]


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("G", [1, 2, 4, 8])
def test_dense_decode_kernel_matches_plain(cuda, dtype, tol, D, G):
    args = _dense_inputs(cuda, 5, 2, G, D, 200, dtype)
    before = fd_kernel.flash_decode.launches
    out = fd_kernel.flash_decode(*args)
    torch.cuda.synchronize()
    assert fd_kernel.flash_decode.launches == before + 1
    assert out.dtype == dtype and not out[0].any()
    torch.testing.assert_close(out.float(),
                               fd_kernel.flash_decode_plain(*args).float(),
                               rtol=tol, atol=tol)


def test_dense_decode_kernel_never_reads_rows_past_valid_len(cuda):
    q, k, v, valid = _dense_inputs(cuda, 6, 2, 4, 64, 300, torch.float32,
                                   seed=1)
    out1 = fd_kernel.flash_decode(q, k, v, valid)
    live = torch.arange(300, device=cuda)[None, :] < valid[:, None]
    k2, v2 = k.clone(), v.clone()
    k2[~live] = 1e4
    v2[~live] = float("nan")
    out2 = fd_kernel.flash_decode(q, k2, v2, valid)
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("S,length", [(1500, 1500), (448, 68), (24, 24)])
def test_dense_decode_kernel_at_whisper_shapes(cuda, dtype, tol, S, length):
    """Whisper's decode: 20 KV heads, G 1, D 64, 8 slots, over 1500
    encoder rows every one valid (not a multiple of the 256-row split),
    a 448-row self-attention cache, and a cache under one tile."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q = torch.randn((8, 20, 1, 64), device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn((8, S, 20, 64), device=cuda, generator=gen).to(dtype)
            for _ in range(2))
    valid = torch.full((8,), length, dtype=torch.int32, device=cuda)
    out = fd_kernel.flash_decode(q, k, v, valid, block_s=S)
    torch.testing.assert_close(
        out.float(), fd_kernel.flash_decode_plain(q, k, v, valid,
                                                  block_s=S).float(),
        rtol=tol, atol=tol)


def test_whisper_decode_on_the_card_matches_the_cpu(cuda):
    """whisper's smoke config (f32): prefill and 6 decode steps on the
    card against the CPU, kernel 2.3 twice a decoder layer a step."""
    from repro_torch.models import whisper

    cfg = configs.get_smoke_config("whisper-large-v3")
    rng = np.random.default_rng(4)
    frames = torch.from_numpy(rng.standard_normal((2, 24, cfg.d_model),
                                                  dtype=np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 10))
                              .astype(np.int32))
    logits = {}
    for dev in ("cpu", "cuda"):
        params = whisper.init_whisper(cfg, seed=3, device=dev)
        out, cache = whisper.prefill(params, cfg, frames.to(dev),
                                     tokens[:, :4].to(dev), max_len=10)
        before = fd_kernel.flash_decode.launches
        steps = [out]
        for t in range(4, 10):
            out, cache = whisper.decode_step(params, cfg,
                                             tokens[:, t:t + 1].to(dev),
                                             cache)
            steps.append(out)
        if dev == "cuda":
            assert fd_kernel.flash_decode.launches - before == \
                2 * whisper.n_dec_layers(cfg) * 6
        logits[dev] = torch.cat(steps, 1).cpu()
    torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4,
                               atol=1e-5)


def test_dense_decode_kernel_refuses_what_it_was_not_built_for(cuda):
    args = _dense_inputs(cuda, 4, 2, 1, 48, 64, torch.float32)
    with pytest.raises(ValueError, match="head dim"):
        fd_kernel.flash_decode(*args)
    args = _dense_inputs(cuda, 4, 2, 1, 64, 64, torch.float32)
    with pytest.raises(ValueError, match="one device"):
        fd_kernel.flash_decode(*args[:3], args[3].cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [6, 12, 20])
@pytest.mark.parametrize("theta", [0.25, 1.1, 6.283185307179586])
def test_rx_gate_kernel_matches_plain(cuda, dtype, n, theta):
    g = torch.Generator(device=cuda).manual_seed(n)
    re, im = (torch.randn((1 << n,), device=cuda, generator=g).to(dtype)
              for _ in range(2))
    for qubit in sorted({0, 1, 4, 5, n - 1}):
        before = qc_kernel.rx_gate.launches
        got = qc_kernel.rx_gate(re, im, qubit, theta)
        torch.cuda.synchronize()
        assert qc_kernel.rx_gate.launches == before + 1
        want = qc_kernel.rx_gate_plain(re, im, qubit, theta)
        for a, b in zip(got, want):
            assert a.dtype == dtype and torch.equal(a, b), qubit


def test_rx_layer_on_the_card_matches_plain_and_keeps_the_norm(cuda):
    re, im = qc_ops.zero_state(16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    re, im = (torch.randn(re.shape, device=cuda, generator=g)
              for _ in range(2))
    o_re, o_im = qc_ops.rx_layer(re, im, 16, 0.3)
    p_re, p_im = re, im
    for q in range(16):
        p_re, p_im = qc_kernel.rx_gate_plain(p_re, p_im, q, 0.3)
    assert torch.equal(o_re, p_re) and torch.equal(o_im, p_im)
    norm = lambda a, b: float((a.double() ** 2 + b.double() ** 2).sum())  # noqa: E731
    assert norm(o_re, o_im) == pytest.approx(norm(re, im), rel=1e-5)


@pytest.mark.parametrize("name,counter", [
    ("kernel/qc-gate", lambda: qc_kernel.rx_gate),
    ("kernel/flash-decode", lambda: fd_kernel.flash_decode),
    ("kernel/flash-prefill", lambda: fd_kernel.flash_prefill_paged),
])
def test_new_workloads_time_their_rois_on_the_card(cuda, name, counter):
    from repro_torch.analysis import analyze
    from repro_torch.core import hw

    before = counter().launches
    r = analyze(name, hw.H100, time_roi=True, device="cuda")
    assert r.wall_s > 0 and counter().launches == before + 2


def test_default_serve_cli_on_the_card_matches_the_cpu(cuda):
    """``python -m repro_torch.launch.serve`` with its defaults (gpt2-124m
    smoke, head dim 16, f32, ``--device cuda``) gives the streams of the
    same command on the CPU."""
    import contextlib
    import io

    from repro_torch.launch import serve as serve_cli

    streams = {}
    for argv in ([], ["--device", "cpu"]):
        args = serve_cli.parse_args(argv)
        engine = serve_cli.make_engine(args)
        engine.warmup()
        before = kernel.flash_decode_paged.launches
        with contextlib.redirect_stdout(io.StringIO()):
            report = serve_cli.serve(args, engine)
        launched = kernel.flash_decode_paged.launches - before
        assert launched == (engine.cfg.n_layers
                            * report["stats"]["fused_steps"]
                            if args.device == "cuda" else 0)
        streams[args.device] = [r["tokens"] for r in report["requests"]]
    assert streams["cuda"] == streams["cpu"]


# -- the train mesh's flat collectives over CUDA IPC ---------------------------


def _flat_collectives(mesh):
    """On each rank of a 2x1 mesh sharing the card: the IPC reduce-scatter,
    all-reduce and all-gather of flat buffers against the same collectives
    staged through the host (gloo), bit for bit."""
    from repro_torch.distributed.collectives import Collectives

    group, n, i = mesh.groups["data"], 2, mesh.data_index
    gen = torch.Generator("cuda").manual_seed(7 + i)
    x = torch.randn(4096 + 3, generator=gen, device="cuda")
    staged = Collectives("gloo", shared_card=False)
    comm = mesh.comm
    assert comm.shared_card
    out = {}
    flat = comm.shared_flat("t", x.numel(), x.dtype, x.device, group, n)
    flat.copy_(x)
    mine, rest = comm.reduce_scatter_flat(flat, group, n, i, tail=3)
    want_mine, want_rest = staged.reduce_scatter_flat(x.clone(), group, n, i,
                                                      tail=3)
    out["reduce_scatter"] = (torch.equal(mine, want_mine)
                             and torch.equal(rest, want_rest))
    flat.copy_(x)
    out["all_reduce"] = torch.equal(comm.all_reduce_flat(flat, group, n),
                                    staged.all_reduce_flat(x.clone(), group,
                                                           n))
    flat.copy_(x)
    out["all_gather"] = torch.equal(comm.all_gather_flat(flat, group, n),
                                    staged.all_gather_flat(x, group, n))
    out["host_bytes"] = comm.counters()["host_bytes"]
    return out


def test_flat_collectives_over_ipc_equal_the_staged_ones(cuda):
    from repro_torch.launch import mesh as mesh_mod

    got = mesh_mod.spawn(_flat_collectives, 2, 1, device="cuda",
                         build=False, timeout=120)
    assert got == {"reduce_scatter": True, "all_reduce": True,
                   "all_gather": True, "host_bytes": 0}
