"""The port's MoE FFN against ``repro.models.moe``.

Inputs are made from a seed with numpy and the weights are the
reference's (``init_moe`` of the JAX package, carried across as numpy).

* ``moe_ffn``: on the deepseek-moe smoke config (8 experts, top 2) and on
  a narrow config with deepseek-moe-16b's routing (64 experts, top 6), at
  ample capacity and at ``capacity_factor`` 0.01, where assignments drop,
  for T from 1 to 64 tokens: the expert indices, the dispatch rows and the
  keep mask equal, the dispatch buffer bit-equal, ``y`` within f32 rtol
  1e-5 and atol 1e-5, ``aux`` within 1e-6.
* ``moe_ffn_rows`` on ``(B, w, d)``: equal to the reference's ``moe_ffn``
  called on each ``x[:, c:c + 1]`` (one routing group of B tokens a row,
  as the reference's chunk step scans its one-token cell), at B = 4, 8
  and 16, with near-identical tokens that overflow one expert's capacity.
* the reference's MoE tests (``tests/test_mla_moe.py``): dropless equals a
  dense reference, aux is 1 when routing is balanced, drops give no NaN,
  permuting tokens permutes outputs.
* ``expert_imbalance`` against the reference's; the stacked init's law.
* the capacity hazard (ROADMAP section 3): below 9 slots no assignment can
  drop, whatever the hidden states; at 9 one can.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.configs.base import MoEConfig as RefMoEConfig  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.models import layers, moe  # noqa: E402
import torch_threads  # noqa: E402

torch_threads.use_threads(2)
RTOL, ATOL, AUX_TOL = 1e-5, 1e-5, 1e-6
ARCH = "deepseek-moe-16b"
TOKENS = (1, 2, 5, 8, 9, 16, 33, 64)


def _configs(kind, capacity=None):
    """(reference config, port config): the smoke config, or a narrow one
    with the full config's 64 experts, top 6 and 2 shared experts."""
    pairs = []
    for get, Moe in ((ref_configs.get_smoke_config, RefMoEConfig),
                     (port_configs.get_smoke_config, MoEConfig)):
        cfg = get(ARCH)
        if kind == "e64k6":
            cfg = dataclasses.replace(cfg, d_model=32, moe=Moe(
                n_routed=64, top_k=6, d_ff_expert=16, n_shared=2,
                first_dense=True))
        if capacity is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity))
        pairs.append(cfg)
    return tuple(pairs)


def _weights(rcfg, seed=0):
    """The reference's MoE weights, as numpy and as the port's tensors."""
    tree = jax.tree.map(np.asarray, ref_moe.init_moe(
        jax.random.PRNGKey(seed), rcfg, jnp.float32))
    return tree, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["smoke", "e64k6"])
@pytest.mark.parametrize("capacity", [None, 0.01], ids=["ample", "tight"])
@pytest.mark.parametrize("T", TOKENS)
def test_moe_ffn_matches_the_reference(kind, capacity, T):
    rcfg, cfg = _configs(kind, capacity)
    tree, params = _weights(rcfg)
    x = _x((1, T, cfg.d_model))
    xf = x.reshape(T, -1)
    m = cfg.moe
    r_gates, r_idx, r_aux = ref_moe._route(tree, rcfg.moe, xf)
    gates, idx, aux = moe._route(params, m, torch.from_numpy(xf))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(r_gates),
                               rtol=RTOL, atol=ATOL)
    C = moe._capacity(m, T)
    assert C == ref_moe._capacity(rcfg.moe, T)
    r_buf, r_slot, r_keep = ref_moe._dispatch(rcfg.moe, xf, r_idx, C)
    buf, slot, keep = moe._dispatch(m, torch.from_numpy(xf)[None],
                                    idx[None], C)
    np.testing.assert_array_equal(keep[0].numpy(), np.asarray(r_keep))
    np.testing.assert_array_equal(slot[0].numpy(), np.asarray(r_slot))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(r_buf))
    if capacity == 0.01 and T == 64:
        assert not keep.all()  # the tight cases do drop
    want_y, want_aux = ref_moe.moe_ffn(tree, rcfg, x)
    y, aux = moe.moe_ffn(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), rtol=RTOL,
                               atol=ATOL)
    assert abs(float(aux) - float(want_aux)) <= AUX_TOL


def _rows_input(B, w, d, skewed):
    """(B, w, d) inputs; ``skewed`` rows are one vector plus 1e-3 noise,
    so every token routes alike and one expert overflows past 8 slots."""
    x = _x((B, w, d), seed=B)
    if skewed:
        x = _x((1, 1, d), seed=0) + 1e-3 * x
    return x


@pytest.mark.parametrize("kind", ["smoke", "e64k6"])
@pytest.mark.parametrize("skewed", [False, True], ids=["random", "skewed"])
@pytest.mark.parametrize("B", [4, 8, 16])
def test_moe_ffn_rows_is_the_reference_per_chunk_row(kind, skewed, B):
    rcfg, cfg = _configs(kind)
    tree, params = _weights(rcfg)
    w = 5
    x = _rows_input(B, w, cfg.d_model, skewed)
    want = np.concatenate([np.asarray(ref_moe.moe_ffn(
        tree, rcfg, x[:, c:c + 1])[0]) for c in range(w)], axis=1)
    got = moe.moe_ffn_rows(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    # the drops: each chunk row's keep mask is the reference's
    C = moe._capacity(cfg.moe, B)
    drops = 0
    for c in range(w):
        xf = x[:, c]
        _, r_idx, _ = ref_moe._route(tree, rcfg.moe, xf)
        _, _, r_keep = ref_moe._dispatch(rcfg.moe, xf, r_idx, C)
        drops += int((~np.asarray(r_keep)).sum())
    xg = torch.from_numpy(x).transpose(0, 1)
    _, idx, _ = moe._route(params, cfg.moe, xg.reshape(B * w, -1))
    _, _, keep = moe._dispatch(cfg.moe, xg, idx.reshape(w, B, -1), C)
    assert int((~keep).sum()) == drops
    assert (drops > 0) == (skewed and B > 8)


def test_moe_ffn_rows_of_one_row_is_moe_ffn():
    rcfg, cfg = _configs("smoke")
    _, params = _weights(rcfg)
    x = torch.from_numpy(_x((6, 1, cfg.d_model)))
    y, _ = moe.moe_ffn(params, cfg, x)
    assert torch.equal(moe.moe_ffn_rows(params, cfg, x), y)


def test_top_k_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = moe._top_k(probs, 2)
    r_vals, r_idx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(r_vals))


# -- the reference's MoE tests ------------------------------------------------


def _moe_cfg(capacity=64.0):
    return _configs("smoke", capacity)


def _moe_dense_reference(params, cfg, x):
    """Every token through its top-k experts with no capacity limit."""
    m = cfg.moe
    B, S, d = x.shape
    xf = x.reshape(B * S, d)
    probs = torch.softmax(xf.float() @ params["router"], dim=-1)
    gates, idx = moe._top_k(probs, m.top_k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    y = torch.zeros_like(xf)
    for e in range(m.n_routed):
        ge = torch.where(idx == e, gates, 0.0).sum(-1)
        h = torch.nn.functional.silu(xf @ params["wi_gate"][e]) * (
            xf @ params["wi_up"][e])
        y = y + ge[:, None] * (h @ params["wo"][e])
    y = y + layers.swiglu(params["shared"], xf)
    return y.reshape(B, S, d)


def test_moe_matches_dense_reference_when_dropless():
    rcfg, cfg = _moe_cfg(capacity=64.0)
    _, params = _weights(rcfg)
    x = torch.from_numpy(_x((2, 6, cfg.d_model)))
    y, aux = moe.moe_ffn(params, cfg, x)
    torch.testing.assert_close(y, _moe_dense_reference(params, cfg, x),
                               rtol=2e-4, atol=2e-4)
    assert np.isfinite(float(aux))


def test_moe_aux_loss_is_one_when_balanced():
    rcfg, cfg = _moe_cfg()
    _, params = _weights(rcfg)
    params = dict(params, router=torch.zeros_like(params["router"]))
    _, aux = moe.moe_ffn(params, cfg, torch.from_numpy(
        _x((2, 8, cfg.d_model))))
    np.testing.assert_allclose(float(aux), 1.0, rtol=0.15)


def test_moe_capacity_drops_tokens_not_nans():
    rcfg, cfg = _moe_cfg(capacity=0.01)
    _, params = _weights(rcfg)
    x = torch.from_numpy(_x((2, 16, cfg.d_model)))
    y, _ = moe.moe_ffn(params, cfg, x)
    assert torch.isfinite(y).all()
    assert torch.isfinite(moe.moe_ffn_rows(params, cfg, x)).all()


def test_moe_permutation_equivariance():
    rcfg, cfg = _moe_cfg(capacity=64.0)
    _, params = _weights(rcfg)
    x = torch.from_numpy(_x((1, 8, cfg.d_model), seed=3))
    perm = torch.tensor([3, 1, 7, 0, 5, 2, 6, 4])
    y1, _ = moe.moe_ffn(params, cfg, x)
    y2, _ = moe.moe_ffn(params, cfg, x[:, perm, :])
    torch.testing.assert_close(y1[:, perm, :], y2, rtol=2e-4, atol=2e-4)


# -- metrics, init, capacity --------------------------------------------------


@pytest.mark.parametrize("loads", [[2, 2, 2], [6, 0, 0], [3, 1], [], [0, 0],
                                   [5.5, -1.0, 2.0], [1, 2, 3, 4, 5, 6]])
def test_expert_imbalance_equals_the_reference(loads):
    assert metrics.expert_imbalance(loads) == \
        ref_metrics.expert_imbalance(loads)


def test_expert_imbalance_on_a_router_census():
    rcfg, cfg = _configs("e64k6")
    _, params = _weights(rcfg)
    x = torch.from_numpy(_x((64, cfg.d_model)))
    _, idx, _ = moe._route(params, cfg.moe, x)
    loads = torch.bincount(idx.reshape(-1), minlength=64).tolist()
    imb = metrics.expert_imbalance(loads)
    assert imb == ref_metrics.expert_imbalance(loads)
    assert 1.0 <= imb <= 64


def test_stacked_init_is_seeded_truncated_and_fan_in_scaled():
    draws = [layers.truncated_normal_stack(
        torch.Generator().manual_seed(5), (4, 256, 64), 1.0, torch.float32,
        "cpu") for _ in range(2)]
    assert torch.equal(*draws)
    x = draws[0]
    std = 1.0 / 256 ** 0.5
    assert x.abs().max() <= 2 * std + 1e-7
    assert abs(x.std().item() / std - 0.959) < 0.01  # clamped at 2 sigma
    assert not torch.equal(x[0], x[1])  # each matrix its own stream
    other = layers.truncated_normal_stack(
        torch.Generator().manual_seed(6), (4, 256, 64), 1.0, torch.float32,
        "cpu")
    assert not torch.equal(other, x)


JAMBA = "jamba-1.5-large-398b"


@pytest.mark.parametrize("arch,get,n_routed", [
    pytest.param(ARCH, "get_config", None, id="get_config"),
    pytest.param(ARCH, "get_smoke_config", None, id="get_smoke_config"),
    pytest.param(JAMBA, "get_config", None, id="jamba-get_config"),
    pytest.param(JAMBA, "get_smoke_config", None,
                 id="jamba-get_smoke_config"),
    pytest.param(JAMBA, "get_config", 8, id="jamba-get_config-8-experts"),
])
def test_capacity_first_binds_past_eight_slots(arch, get, n_routed):
    """The engines' routing groups are the step's B slots, idle and padded
    rows included.  Each token assigns at most one row to an expert, so
    while ``_capacity(m, B) >= B`` nothing drops, whatever the rows hold;
    from the first B where it is smaller, a padded row (whose hidden state
    the port and the reference need not share) can push a live token's
    assignment out.  For deepseek-moe-16b, full and smoke, that B is 9;
    for jamba's 16 experts, top 2 (capacity 8 up to B = 51), its smoke
    config's 4 and the card's cut to 8, too."""
    cfg = getattr(port_configs, get)(arch)
    m = cfg.moe
    if n_routed is not None:
        m = dataclasses.replace(m, n_routed=n_routed)
    first = next(B for B in range(1, 64) if moe._capacity(m, B) < B)
    assert first == 9
    assert first == next(B for B in range(1, 64)
                         if ref_moe._capacity(m, B) < B)
    assert moe._capacity(m, 8) == 8
    small = dataclasses.replace(cfg, d_model=32, moe=dataclasses.replace(
        m, d_ff_expert=16))
    rsmall = dataclasses.replace(
        ref_configs.get_smoke_config(arch), d_model=32,
        moe=RefMoEConfig(**dataclasses.asdict(small.moe)))
    _, params = _weights(rsmall)
    for B, dropped in ((8, False), (9, True)):
        x = torch.from_numpy(np.repeat(_x((1, 1, 32)), B, axis=0))
        _, idx, _ = moe._route(params, m, x[:, 0])
        _, _, keep = moe._dispatch(m, x.transpose(0, 1), idx[None],
                                   moe._capacity(m, B))
        assert bool((~keep).any()) == dropped
