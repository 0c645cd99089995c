"""The port's contiguous-cache flash-decode (TPU kernel 2.3) and its
registry ops ``flash-decode`` and ``flash-prefill`` against the
reference's.

On the CPU each wrapper runs its plain version, which is held against the
JAX Pallas kernel in interpret mode and against the JAX oracle, on the
same numpy inputs.  The CUDA kernels run only on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).

Tolerances:
- plain vs ``decode_ref`` in fp32: 1e-5 (the same fp32 masked softmax,
  summed in another order);
- plain vs the Pallas kernel in fp32: 3e-5, the bound the reference's own
  kernel tests use for its online softmax; in bf16 2e-2, since the Pallas
  kernel rounds p to bf16 before p @ V (``kernel.py:59``) where the port,
  like ``decode_ref``, keeps p in fp32, and both round outputs of order 1
  to bf16;
- the ``flash-prefill`` op vs the reference's: live rows rtol 1e-4 /
  atol 1e-5 (as ``tests/test_torch_prefill.py``), pools through the
  tables bit-equal (a commit is a copy).
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import registry as jreg  # noqa: E402
from repro.kernels.flash_decode import kernel as jfd_k  # noqa: E402
from repro.kernels.flash_decode import ref as jfd_r  # noqa: E402
from repro_torch.kernels import registry  # noqa: E402
from repro_torch.kernels.flash_decode import kernel, ops, ref  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}

FD_CASES = [
    # B, KV, G, D, S, bs (tests/test_kernels.py FD_CASES)
    (1, 1, 1, 16, 32, 8),
    (2, 2, 3, 16, 64, 16),
    (2, 4, 2, 32, 128, 32),
    (3, 2, 4, 16, 64, 64),  # single block
]


def _pair(arr: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    if arr.dtype == np.int32:
        return jnp.asarray(arr), torch.from_numpy(arr)
    j = jnp.asarray(arr, _JNP[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _decode_inputs(B, KV, G, D, S, seed=0, dtype="float32", valid=None):
    """(jax args, torch args): q, k, v, valid_len with lengths ragged in
    [1, S], 1 and S among them, unless given."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, KV, G, D), (B, S, KV, D), (B, S, KV, D))]
    if valid is None:
        valid = rng.integers(1, S + 1, size=B)
        valid[0] = 1
        valid[-1] = S
    pairs = [_pair(a, dtype) for a in arrays]
    pairs.append(_pair(np.asarray(valid, np.int32)))
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("B,KV,G,D,S,bs", FD_CASES)
def test_plain_matches_the_pallas_kernel_and_the_oracle(B, KV, G, D, S, bs):
    jargs, targs = _decode_inputs(B, KV, G, D, S)
    got = registry.FLASH_DECODE(*targs, block_s=bs)
    assert got.shape == (B, KV, G, D) and got.dtype == torch.float32
    want = jfd_k.flash_decode(*jargs, block_s=bs)
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-5, atol=3e-5)
    oracle = jfd_r.decode_ref(*jargs)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(ref.decode_ref(*targs)), _np(oracle),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,KV,G,D,S,bs", FD_CASES)
def test_bf16_plain_matches_the_pallas_kernel(B, KV, G, D, S, bs):
    jargs, targs = _decode_inputs(B, KV, G, D, S, seed=3, dtype="bfloat16")
    got = kernel.flash_decode(*targs, block_s=bs)
    assert got.dtype == torch.bfloat16
    want = jfd_k.flash_decode(*jargs, block_s=bs)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-2, atol=2e-2)


def test_masked_tail_is_inert():
    B, KV, G, D, S = 1, 2, 2, 16, 64
    _, (q, k, v, valid) = _decode_inputs(B, KV, G, D, S, seed=1,
                                         valid=[40])
    out1 = kernel.flash_decode(q, k, v, valid, block_s=16)
    k2, v2 = k.clone(), v.clone()
    k2[:, 40:] = 99.0
    v2[:, 40:] = -99.0
    out2 = kernel.flash_decode(q, k2, v2, valid, block_s=16)
    np.testing.assert_allclose(_np(out1), _np(out2), rtol=1e-6, atol=1e-6)


def test_empty_slot_gives_zeros_as_the_pallas_kernel_does():
    """valid_len 0: the Pallas kernel's clamped sum gives zeros, which the
    port follows; the oracle gives the mean of v instead."""
    jargs, targs = _decode_inputs(2, 2, 2, 16, 32, seed=2, valid=[0, 32])
    got = kernel.flash_decode(*targs, block_s=8)
    want = jfd_k.flash_decode(*jargs, block_s=8)
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-5, atol=3e-5)
    assert not got[0].any()
    oracle = ref.decode_ref(*targs)
    mean_v = targs[2][0].mean(0)[:, None, :].expand(2, 2, 16)  # (KV,G,D)
    np.testing.assert_allclose(_np(oracle[0]), _np(mean_v), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bs", [8, 16])
def test_identity_tables_make_the_paged_cache_the_contiguous_one(bs):
    B, KV, G, D, S = 3, 2, 4, 32, 64
    _, (q, k, v, valid) = _decode_inputs(B, KV, G, D, S, seed=5)
    pools = [x.reshape(B * S // bs, bs, KV, D) for x in (k, v)]
    tables = torch.arange(B * S // bs, dtype=torch.int32).reshape(B, S // bs)
    paged = kernel.flash_decode_paged(q, *pools, tables, valid)
    dense = kernel.flash_decode(q, k, v, valid, block_s=bs)
    torch.testing.assert_close(paged, dense, rtol=0, atol=0)


@pytest.mark.parametrize("valid,S,block_s", [
    ([100, 512, 30], 512, 64), ([1, 1], 64, 16), ([0, 64, 65], 64, 16),
    ([4096] * 4, 4096, 512),
])
def test_issue_counts_equal_the_reference(valid, S, block_s):
    assert ref.issue_counts(valid, S, block_s) == \
        jfd_r.issue_counts(valid, S, block_s)


def test_issue_model():
    c = ref.issue_counts([100, 512, 30], S=512, block_s=64)
    assert c["predicated"] == 2 + 8 + 1
    assert c["fixed"] == 3 * 8
    assert c["r_issue"] > 2.0


@pytest.mark.parametrize("args", [
    (2, 2, 4, 16, (40, 64), 4), (32, 8, 2, 128, (1, 4096, 77), 2),
    (1, 12, 1, 64, (), 2),
])
def test_flops_bytes_equal_the_reference(args):
    assert ref.flops_bytes(*args) == jfd_r.flops_bytes(*args)


@pytest.mark.parametrize("args", [
    (2, 16, 2, 4, 16, (24, 0), 4), (8, 64, 8, 2, 128, (0, 448, 17), 2),
])
def test_prefill_flops_bytes_equal_the_reference(args):
    assert ref.prefill_flops_bytes(*args) == jfd_r.prefill_flops_bytes(*args)


def test_decode_work_terms_count_each_live_byte_once():
    q = torch.zeros(2, 2, 4, 16, dtype=torch.bfloat16)
    k = torch.zeros(2, 64, 2, 16, dtype=torch.bfloat16)
    terms = ref.decode_work_terms(q, k, [40, 99])  # 99 clamps to 64
    live = 40 + 64
    assert terms["flops"] == 4.0 * live * 2 * 4 * 16
    assert terms["bytes"] == 2 * 2 * 2 * 4 * 16 * 2 + 2 * live * 2 * 16 * 2 \
        + 4 * 2
    assert ref.decode_work_terms(q, k, [0, -3])["flops"] == 0.0


def _prefill_problem(q_len=None, seed=0):
    """The registry workload's problem (B2 C16 KV2 G4 D16, blocks of 8, 8
    a slot, q_start (24, 0)), numpy-seeded."""
    B, C, KV, G, D, bs, nb = 2, 16, 2, 4, 16, 8, 8
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * nb
    arrays = [rng.standard_normal(s).astype(np.float32) for s in (
        (B, C, KV, G, D), (B, C, KV, D), (B, C, KV, D),
        (n_blocks, bs, KV, D), (n_blocks, bs, KV, D))]
    ints = [1 + np.arange(B * nb, dtype=np.int32).reshape(B, nb),
            np.asarray([24, 0], np.int32)]
    if q_len is not None:
        ints.append(np.asarray(q_len, np.int32))
    pairs = [_pair(a) for a in arrays + ints]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("q_len", [None, [5, 16], [0, 1]])
def test_flash_prefill_op_matches_the_reference(q_len):
    jargs, targs = _prefill_problem(q_len)
    kp0, vp0 = targs[3].clone(), targs[4].clone()
    want, jkp, jvp = jreg.FLASH_PREFILL(*jargs, block_c=8)
    out, kp, vp = ops.flash_prefill(*targs, block_c=8)
    assert kp is targs[3] and vp is targs[4]  # committed in place
    lens = [16, 16] if q_len is None else q_len
    for b, n in enumerate(lens):
        np.testing.assert_allclose(_np(out[b, :n]), _np(want[b, :n]),
                                   rtol=1e-4, atol=1e-5)
        assert not out[b, n:].any()
    bt = targs[5].long()
    np.testing.assert_array_equal(_np(kp[bt]), _np(jkp)[_np(bt).astype(int)])
    np.testing.assert_array_equal(_np(vp[bt]), _np(jvp)[_np(bt).astype(int)])
    # the functional oracle leaves its pools as they were
    oracle, okp, _ = ops.flash_prefill.ref(targs[0], *targs[1:3], kp0, vp0,
                                           *targs[5:])
    torch.testing.assert_close(oracle, out, rtol=0, atol=0)
    assert not torch.equal(okp, kp0) and torch.equal(okp, kp)


def test_registered_workloads_run_their_ops_on_the_cpu():
    from repro_torch.analysis import get_workload

    before = (kernel.flash_decode.launches,
              kernel.flash_prefill_paged.launches)
    wl = get_workload("kernel/flash-decode")
    q, k, v, vl = wl.example_args()
    assert vl.tolist() == [40, 64] and k.shape == (2, 64, 2, 16)
    torch.testing.assert_close(wl.fn(q, k, v, vl), ref.decode_ref(q, k, v,
                                                                  vl),
                               rtol=1e-5, atol=1e-5)
    wl = get_workload("kernel/flash-prefill")
    args = wl.example_args()
    assert wl.fn(*args).shape == (2, 16, 2, 4, 16)
    assert (kernel.flash_decode.launches,
            kernel.flash_prefill_paged.launches) == before


def test_decode_checks_match_the_reference():
    jargs, targs = _decode_inputs(2, 2, 2, 16, 64)
    with pytest.raises(AssertionError):
        jfd_k.flash_decode(*jargs, block_s=24)
    for fn in (kernel.flash_decode, kernel.flash_decode_plain):
        with pytest.raises(ValueError, match="block_s"):
            fn(*targs, block_s=24)
        with pytest.raises(ValueError, match="block_s"):
            fn(*targs, block_s=0)
    q, k, v, vl = targs
    with pytest.raises(ValueError, match="k must be"):
        kernel.flash_decode(q, k[:, :, :1], v, vl)
    with pytest.raises(ValueError, match="v "):
        kernel.flash_decode(q, k, v[:, :32], vl)
    with pytest.raises(ValueError, match="valid_len"):
        kernel.flash_decode(q, k, v, vl[:1])
    with pytest.raises(TypeError):
        kernel.flash_decode(q.double(), k.double(), v.double(), vl)
    with pytest.raises(TypeError):
        kernel.flash_decode(q, k, v, vl.long())
    with pytest.raises(ValueError, match="contiguous"):
        kernel.flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2),
                            v, vl)


def test_prefill_op_checks_match_the_reference():
    jargs, targs = _prefill_problem()
    with pytest.raises(AssertionError):
        jfd_k.flash_prefill_paged(*jargs, block_c=5)
    with pytest.raises(AssertionError):
        jfd_k.flash_prefill_paged(*jargs, block_s=3)
    for fn in (ops.flash_prefill, ops.flash_prefill.interpret):
        with pytest.raises(ValueError, match="block_c"):
            fn(*targs, block_c=5)
        with pytest.raises(ValueError, match="block_s"):
            fn(*targs, block_s=3)
        # scales are taken with int8 pools only, and only in pairs, as the
        # reference asks them
        with pytest.raises(ValueError, match="only int8"):
            fn(*targs, k_scale=torch.ones(17, 8), v_scale=torch.ones(17, 8))
        with pytest.raises(ValueError, match="together"):
            fn(*targs, k_scale=torch.ones(17, 8))
    # block_s dividing the block size (or 0) is accepted, as in the reference
    out, _, _ = ops.flash_prefill(*targs, block_c=16, block_s=4)
    assert out.shape == targs[0].shape


def test_cpu_calls_launch_nothing():
    _, targs = _decode_inputs(2, 2, 2, 16, 64)
    before = kernel.flash_decode.launches
    ops.flash_decode(*targs, block_s=16)
    ops.flash_decode.interpret(*targs, block_s=16)
    assert kernel.flash_decode.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_decode.kernel(*targs)
    _, pargs = _prefill_problem()
    before = kernel.flash_prefill_paged.launches
    ops.flash_prefill(*pargs)
    assert kernel.flash_prefill_paged.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_prefill.kernel(*pargs)
