"""The head-sharded paged decode (the reference's ``head_shard=(i, n)`` and
``flash_decode_paged_sharded``) and the commit with a given row amax,
mirroring ``TestHeadShardedKernel`` of ``tests/test_sharded_serve.py``.

On the CPU the wrappers run their plain versions.  Attention is
independent per head, so the slices of every (q, pool) dtype pair,
concatenated, equal the unsharded call bit for bit; against the JAX
kernel in interpret mode they agree within the fp32 tolerance of the
port's decode tests (1e-5), the two summing in another order.  A commit
given each row's amax over all heads writes codes and scales bit-equal to
the unsharded commit's head slice, which is bit-equal to the Pallas
commit.  The sharded wrapper runs on a one-rank gloo group in this process
and over two spawned gloo ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro.kernels.flash_decode import kernel as pallas  # noqa: E402
from repro.launch.mesh import make_serve_mesh as ref_mesh  # noqa: E402
from repro_torch.kernels.flash_decode import kernel, ref  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

#: the fp32 tolerance of the port's decode tests
TOL = 1e-5
PAIRS = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.float32, torch.int8), (torch.bfloat16, torch.bfloat16),
         (torch.bfloat16, torch.int8)]
PAIR_IDS = ["f32-f32", "f32-bf16", "f32-int8", "bf16-bf16", "bf16-int8"]


def _toy(seed=0):
    """The reference test's inputs: B 2, KV 4, G 2, D 8, pools of 9
    blocks of 4 rows, 3 blocks a slot, lengths 7 and 11."""
    rng = np.random.default_rng(seed)
    B, KV, G, D, bs, nblk, nb = 2, 4, 2, 8, 4, 9, 3
    q = rng.standard_normal((B, KV, G, D)).astype(np.float32)
    kp = rng.standard_normal((nblk, bs, KV, D)).astype(np.float32)
    vp = rng.standard_normal((nblk, bs, KV, D)).astype(np.float32)
    bt = (rng.permutation(nblk - 1)[:B * nb].reshape(B, nb) + 1
          ).astype(np.int32)
    vl = np.array([7, 11], np.int32)
    return q, kp, vp, bt, vl


def _torch_args(arrays, q_dtype=torch.float32, pool_dtype=torch.float32):
    """The toy as the port takes it: q and pools in the pair's dtypes,
    int8 pools quantized per row with their scales."""
    q, kp, vp, bt, vl = (torch.from_numpy(a) for a in arrays)
    scales = ()
    if pool_dtype == torch.int8:
        (kp, ks), (vp, vs) = ref.quantize_rows(kp), ref.quantize_rows(vp)
        scales = (ks, vs)
    else:
        kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    return (q.to(q_dtype), kp, vp, bt, vl, *scales)


@pytest.fixture(scope="module")
def mesh_1x1():
    """A one-rank gloo group in this process and its 1x1 mesh."""
    mesh_mod.init_rank(0, 1, mesh_mod.free_port(), "gloo", timeout=60)
    try:
        yield mesh_mod.make_serve_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("pair", PAIRS, ids=PAIR_IDS)
@pytest.mark.parametrize("n", [1, 2, 4])
def test_head_shard_concat_equals_full(pair, n):
    args = _torch_args(_toy(), *pair)
    full = kernel.flash_decode_paged(*args)
    parts = [kernel.flash_decode_paged(*args, head_shard=(i, n))
             for i in range(n)]
    assert all(p.shape == (2, 4 // n, 2, 8) for p in parts)
    assert torch.equal(torch.cat(parts, dim=1), full)
    assert torch.equal(ref.flash_decode_paged_sharded_ref(*args[:5], n,
                                                          *args[5:]), full)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_head_shard_matches_the_jax_slices(n):
    arrays = _toy()
    for i in range(n):
        got = kernel.flash_decode_paged(*_torch_args(arrays),
                                        head_shard=(i, n))
        want = pallas.flash_decode_paged(*arrays, head_shard=(i, n),
                                         interpret=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


def test_head_shard_validation():
    args = _torch_args(_toy())
    with pytest.raises(ValueError, match="not divisible"):
        kernel.flash_decode_paged(*args, head_shard=(0, 3))
    with pytest.raises(ValueError, match="outside"):
        kernel.flash_decode_paged(*args, head_shard=(2, 2))
    with pytest.raises(ValueError, match="outside"):
        kernel.flash_decode_paged(*args, head_shard=(-1, 2))


def test_sharded_wrapper_on_trivial_mesh(mesh_1x1):
    arrays = _toy()
    args = _torch_args(arrays)
    full = kernel.flash_decode_paged(*args)
    before = kernel.flash_decode_paged_sharded.launches
    got = kernel.flash_decode_paged_sharded(*args, mesh=mesh_1x1)
    gathered = kernel.flash_decode_paged_sharded(*args, mesh=mesh_1x1,
                                                 gather=True)
    assert torch.equal(got, full) and torch.equal(gathered, full)
    # the CPU runs the plain version: no kernel launch is counted
    assert kernel.flash_decode_paged_sharded.launches == before
    want = pallas.flash_decode_paged_sharded(*arrays, mesh=ref_mesh(1, 1),
                                             interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_sharded_wrapper_checks_its_scales(mesh_1x1):
    q, kp, vp, bt, vl, ks, vs = _torch_args(_toy(), torch.float32,
                                            torch.int8)
    with pytest.raises(ValueError, match="together"):
        kernel.flash_decode_paged_sharded(q, kp, vp, bt, vl, mesh=mesh_1x1,
                                          k_scale=ks)
    # a q whose local heads are not the pools' (pools left whole)
    with pytest.raises(ValueError):
        kernel.flash_decode_paged_sharded(q[:, :2].contiguous(), kp, vp, bt,
                                          vl, mesh=mesh_1x1, k_scale=ks,
                                          v_scale=vs)


def _decode_on_ranks(mesh, arrays, quantized):
    """One rank's call of the sharded decode on its local heads."""
    pool = torch.int8 if quantized else torch.float32
    q, kp, vp, bt, vl, *scales = _torch_args(arrays, torch.float32, pool)
    h = ref.head_slice((mesh.model_index, mesh.model), q.shape[1])
    local = [t[:, h].contiguous() for t in (q,)] + [
        t[:, :, h].contiguous() for t in (kp, vp)]
    kw = dict(zip(("k_scale", "v_scale"), scales))
    out = kernel.flash_decode_paged_sharded(*local, bt, vl, mesh=mesh, **kw)
    whole = kernel.flash_decode_paged_sharded(*local, bt, vl, mesh=mesh,
                                              gather=True, **kw)
    return out.numpy(), whole.numpy(), mesh.comm.counters()


def _rank_jobs(mesh, toy, commit):
    """Everything the tests below run on two ranks, in one spawn."""
    return {"decode": [_decode_on_ranks(mesh, toy, q) for q in (False, True)],
            "commit": _mesh_commit(mesh, commit)}


@pytest.fixture(scope="module")
def two_ranks():
    """The sharded decode (f32 and int8 pools) and the mesh commit, run
    on a 1x2 mesh of spawned gloo ranks."""
    return mesh_mod.spawn(_rank_jobs, 1, 2, _toy(), _commit_inputs(),
                          device="cpu", timeout=120)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_sharded_wrapper_over_two_gloo_ranks(two_ranks, quantized):
    arrays = _toy()
    local, whole, counters = two_ranks["decode"][quantized]
    pool = torch.int8 if quantized else torch.float32
    full = kernel.flash_decode_paged(*_torch_args(arrays, torch.float32,
                                                  pool)).numpy()
    np.testing.assert_array_equal(whole, full)
    np.testing.assert_array_equal(local, full[:, :2])
    # the decode needs no collective; each call with gather=True, one
    assert counters["calls"] == 1 + quantized
    if not quantized:
        want = np.asarray(pallas.flash_decode_paged(*arrays, interpret=True))
        np.testing.assert_allclose(whole, want, rtol=TOL, atol=TOL)


# -- the commit with a given row amax -----------------------------------------


def _commit_inputs(seed=5, B=2, C=4, KV=4, D=16, bs=8, nb=3):
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * nb
    kq, ks = (np.asarray(a) for a in ref.quantize_rows(torch.from_numpy(
        rng.standard_normal((n_blocks, bs, KV, D)).astype(np.float32))))
    vq, vs = (np.asarray(a) for a in ref.quantize_rows(torch.from_numpy(
        rng.standard_normal((n_blocks, bs, KV, D)).astype(np.float32))))
    bt = rng.permutation(np.arange(1, n_blocks))[:B * nb].reshape(B, nb)
    k_new = rng.standard_normal((B, C, KV, D)).astype(np.float32)
    v_new = rng.standard_normal((B, C, KV, D)).astype(np.float32)
    q_start = np.array([0, 9], np.int32)
    q_len = np.array([C, 3], np.int32)
    return (k_new, v_new, kq, vq, bt.astype(np.int32), q_start, q_len, ks,
            vs)


def _pallas_commit(arrays):
    """The Pallas chunk commit of the whole rows (q is irrelevant to the
    commit): its codes and scales."""
    k_new, v_new, kq, vq, bt, q_start, q_len, ks, vs = arrays
    B, C, KV, D = k_new.shape
    q = np.zeros((B, C, KV, 1, D), np.float32)
    _, kp, vp, kst, vst = pallas.flash_prefill_paged(
        *(jnp.asarray(a) for a in (q, k_new, v_new, kq, vq, bt, q_start,
                                   q_len)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs), block_c=C,
        interpret=True)
    return [np.asarray(a) for a in (kp, vp, kst, vst)]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("via", ["commit_paged", "flash_prefill_paged"])
def test_commit_with_given_amax_is_the_head_slice(n, via):
    arrays = _commit_inputs()
    k_new, v_new, kq, vq, bt, q_start, q_len, ks, vs = arrays
    KV = k_new.shape[2]
    k_amax, v_amax = (ref.row_amax(torch.from_numpy(a))
                      for a in (k_new, v_new))
    want = _pallas_commit(arrays)
    named = np.unique(bt)
    for i in range(n):
        h = ref.head_slice((i, n), KV)
        kn, vn, kp, vp = (torch.from_numpy(np.ascontiguousarray(a[..., h, :]))
                          for a in (k_new, v_new, kq, vq))
        ksc, vsc = torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())
        ints = [torch.from_numpy(a) for a in (bt, q_start, q_len)]
        amax = dict(k_amax=k_amax, v_amax=v_amax)
        if via == "commit_paged":
            kernel.commit_paged(kn, vn, kp, vp, *ints, ksc, vsc, **amax)
        else:
            q = torch.zeros(kn.shape[:3] + (1, kn.shape[3]))
            kernel.flash_prefill_paged(q, kn, vn, kp, vp, *ints, ksc, vsc,
                                       **amax)
        for got, full in ((kp, want[0]), (vp, want[1])):
            np.testing.assert_array_equal(got.numpy()[named],
                                          full[..., h, :][named])
        for got, full in ((ksc, want[2]), (vsc, want[3])):
            np.testing.assert_array_equal(got.numpy()[named], full[named])


def test_commit_amax_validation():
    arrays = _commit_inputs()
    t = [torch.from_numpy(a) for a in arrays]
    amax = ref.row_amax(t[0])
    with pytest.raises(ValueError, match="together"):
        kernel.commit_paged(*t, k_amax=amax)
    with pytest.raises(ValueError, match=r"\(2, 4\) float32"):
        kernel.commit_paged(*t, k_amax=amax[:1], v_amax=amax[:1])
    f32 = [t[0], t[1], t[2].float(), t[3].float(), *t[4:7]]
    with pytest.raises(ValueError, match="only with int8"):
        kernel.commit_paged(*f32, k_amax=amax, v_amax=amax)


def _mesh_commit(mesh, arrays):
    """One rank's commit of its head slice, with each row's amax the MAX
    over the model axis of the local ones, as the mesh engine does."""
    k_new, v_new, kq, vq, bt, q_start, q_len, ks, vs = arrays
    h = ref.head_slice((mesh.model_index, mesh.model), k_new.shape[2])
    kn, vn, kp, vp = (torch.from_numpy(np.ascontiguousarray(a[..., h, :]))
                      for a in (k_new, v_new, kq, vq))
    ksc, vsc = torch.from_numpy(ks.copy()), torch.from_numpy(vs.copy())
    kernel.commit_paged(kn, vn, kp, vp,
                        *(torch.from_numpy(a) for a in (bt, q_start, q_len)),
                        ksc, vsc, k_amax=mesh.max(ref.row_amax(kn), "model"),
                        v_amax=mesh.max(ref.row_amax(vn), "model"))
    ranks = [None] * mesh.size
    dist.all_gather_object(ranks, [a.numpy() for a in (kp, vp, ksc, vsc)])
    return ranks


def test_mesh_commit_over_two_gloo_ranks_is_the_pallas_commit(two_ranks):
    arrays = _commit_inputs()
    ranks = two_ranks["commit"]
    want = _pallas_commit(arrays)
    named = np.unique(arrays[4])
    for m, (kp, vp, ksc, vsc) in enumerate(ranks):
        h = ref.head_slice((m, 2), arrays[0].shape[2])
        np.testing.assert_array_equal(kp[named], want[0][..., h, :][named])
        np.testing.assert_array_equal(vp[named], want[1][..., h, :][named])
        np.testing.assert_array_equal(ksc[named], want[2][named])
        np.testing.assert_array_equal(vsc[named], want[3][named])
