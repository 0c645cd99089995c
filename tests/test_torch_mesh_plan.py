"""The port's mesh plan (``distributed/context.py``) and MoE's hierarchical
and shard_map layouts against ``repro.distributed.context`` and
``repro.models.moe``: the counterparts of
``tests/test_distribution_plans.py``.

The MoE layouts run on the deepseek-moe smoke config (8 experts, top 2,
capacity factor 1.25) with the reference's weights, on a (4, 16) batch
where per-shard capacity binds: the reference's hierarchical layout there
differs from its global one, and so must the port's.  The reference's
hierarchical layout runs with no JAX mesh (its constraints are no-ops
then); its shard_map layout needs one, so it is compared on a (1, 1)
mesh.  Tolerances: y rtol 1e-5 and atol 1e-5, aux rtol 1e-6, gradients
rtol 1e-4 and atol 1e-5, the loss under a plan rtol 2e-4 and atol 1e-5
(the reference's bound).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.distributed import context as ref_ctx  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
import repro_torch.configs as port_configs  # noqa: E402
from repro_torch.distributed import context as ctx  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, MeshShapeError,  # noqa: E402
                                     ServeMesh)
from repro_torch.distributed.tensor_parallel import TrainView  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import MeshContext  # noqa: E402
from repro_torch.train import steps  # noqa: E402
import torch_threads  # noqa: E402
import torch_train_checks as checks  # noqa: E402

torch_threads.use_threads(2)

Y = dict(rtol=1e-5, atol=1e-5)
AUX = dict(rtol=1e-6, atol=0)
GRADS = dict(rtol=1e-4, atol=1e-5)
LOSS = dict(rtol=2e-4, atol=1e-5)
#: (B, S) of the MoE inputs: per-shard capacity binds at Z = 2 and 4
SHAPE = (4, 16)


def _moe_setup():
    rcfg = ref_configs.get_smoke_config("deepseek-moe-16b")
    cfg = port_configs.get_smoke_config("deepseek-moe-16b")
    rp = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg, jnp.float32)
    params = {k: ({kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
                  if isinstance(v, dict) else torch.from_numpy(np.array(v)))
              for k, v in rp.items()}
    x = np.random.default_rng(1).standard_normal(
        SHAPE + (rcfg.d_model,)).astype(np.float32)
    return rcfg, cfg, rp, params, x


def _ref_hierarchical(rcfg, rp, x, Z):
    plan = ref_ctx.MeshPlan(n_data=Z, data_axes=("data",),
                            moe_impl="hierarchical")
    with ref_ctx.use_plan(plan):
        return jax.jit(lambda p, x: ref_moe.moe_ffn(p, rcfg, x))(
            rp, jnp.asarray(x))


def _port(params, cfg, x, plan, mesh=None):
    with ctx.use_plan(plan):
        return moe.moe_ffn(params, cfg, torch.from_numpy(x), mesh)


def _assert_y(y, aux, ry, raux):
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **Y)
    np.testing.assert_allclose(float(aux), float(raux), **AUX)


# -- the plan -----------------------------------------------------------------


def test_default_plan_is_inactive():
    plan = ctx.current()
    assert not plan.active and plan.moe_impl == "global"
    assert (plan.n_data, plan.n_model, plan.data_axes,
            plan.model_axis) == (1, 1, (), None)


def test_use_plan_scopes_correctly():
    plan = ctx.MeshPlan(n_data=4, data_axes=("data",), model_axis="model")
    with ctx.use_plan(plan) as got:
        assert got is plan and ctx.current().n_data == 4
        assert ctx.current().active
    assert ctx.current().n_data == 1 and not ctx.current().active


@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (2, 2)])
def test_plan_for_mesh_axes(data, model):
    mesh = MeshShape(data, model)
    plan = ctx.plan_for_mesh(mesh, moe_impl="shard_map")
    assert plan.data_axes == ("data",) and plan.model_axis == "model"
    assert (plan.n_data, plan.n_model) == (data, model)
    assert plan.moe_impl == "shard_map"
    assert plan.mesh is mesh and plan.active
    assert not plan.moe_hierarchical


def test_plan_for_mesh_equals_the_reference_on_a_one_device_mesh():
    fields = ("n_data", "n_model", "data_axes", "model_axis", "moe_impl",
              "moe_hierarchical", "active")
    want = ref_ctx.plan_for_mesh(jax.make_mesh((1, 1), ("data", "model")),
                                 moe_impl="hierarchical")
    got = ctx.plan_for_mesh(MeshShape(1, 1), moe_impl="hierarchical")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]


def test_unknown_moe_impl_raises():
    with pytest.raises(ValueError, match="moe_impl"):
        ctx.MeshPlan(moe_impl="ring")


# -- MoE layouts --------------------------------------------------------------


@pytest.mark.parametrize("Z", [2, 4])
def test_hierarchical_moe_matches_the_reference(Z):
    """Z routing groups of T/Z tokens, each with its own capacity, and the
    mean of their aux, as the reference's hierarchical layout; capacity
    binds here, so the global layout differs."""
    rcfg, cfg, rp, params, x = _moe_setup()
    ry, raux = _ref_hierarchical(rcfg, rp, x, Z)
    y, aux = _port(params, cfg, x, ctx.MeshPlan(
        n_data=Z, data_axes=("data",), moe_impl="hierarchical"))
    _assert_y(y, aux, ry, raux)
    gy, gaux = ref_moe.moe_ffn(rp, rcfg, jnp.asarray(x))
    assert np.abs(y.numpy() - np.asarray(gy)).max() > 0.1
    assert abs(float(aux) - float(gaux)) > 1e-3
    # no plan: the global layout
    y0, aux0 = moe.moe_ffn(params, cfg, torch.from_numpy(x))
    _assert_y(y0, aux0, gy, gaux)


def test_hierarchical_needs_whole_sequences_a_shard():
    """B not divisible by Z: the global layout, as the reference falls
    back."""
    rcfg, cfg, rp, params, x = _moe_setup()
    x = x[:3]
    gy, gaux = ref_moe.moe_ffn(rp, rcfg, jnp.asarray(x))
    y, aux = _port(params, cfg, x, ctx.MeshPlan(
        n_data=2, data_axes=("data",), moe_impl="hierarchical"))
    _assert_y(y, aux, gy, gaux)


@pytest.mark.parametrize("data,model", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_shard_map_moe_matches_the_reference_hierarchical(data, model):
    """Routing and capacity per data shard, the experts in ``model``
    slices whose partial outputs sum to the whole combine: in one process,
    the reference's hierarchical layout at Z = ``data``."""
    rcfg, cfg, rp, params, x = _moe_setup()
    ry, raux = _ref_hierarchical(rcfg, rp, x, data)
    y, aux = _port(params, cfg, x, ctx.plan_for_mesh(
        MeshShape(data, model), moe_impl="shard_map"))
    _assert_y(y, aux, ry, raux)


@pytest.mark.parametrize("data,model", [(3, 1), (2, 3)])
def test_shard_map_needs_whole_shards_and_expert_slices(data, model):
    """B (4) not divisible by ``data``, or the 8 experts not by ``model``:
    the global layout, as the reference falls back."""
    rcfg, cfg, rp, params, x = _moe_setup()
    gy, gaux = ref_moe.moe_ffn(rp, rcfg, jnp.asarray(x))
    y, aux = _port(params, cfg, x, ctx.plan_for_mesh(
        MeshShape(data, model), moe_impl="shard_map"))
    _assert_y(y, aux, gy, gaux)


def test_shard_map_moe_matches_the_reference_shard_map_on_one_device():
    rcfg, cfg, rp, params, x = _moe_setup()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with ref_ctx.use_plan(ref_ctx.plan_for_mesh(mesh, moe_impl="shard_map")), \
            mesh:
        ry, raux = jax.jit(lambda p, x: ref_moe.moe_ffn(p, rcfg, x))(
            rp, jnp.asarray(x))
    y, aux = _port(params, cfg, x, ctx.plan_for_mesh(
        MeshShape(1, 1), moe_impl="shard_map"))
    _assert_y(y, aux, ry, raux)


@pytest.mark.parametrize("impl", ["hierarchical", "shard_map"])
def test_a_mesh_of_ranks_names_the_roadmap_item(impl):
    """A plan over a mesh of ranks, refused until ROADMAP item 1.18.2,
    now runs its layout across the ranks under a train step's
    ``MeshContext`` (``_moe_ffn_ranks``; the layouts on meshes of spawned
    ranks are ``tests/test_torch_train_mesh_moe.py``'s): on a mesh of one
    rank, the reference's layout at Z = 1."""
    rcfg, cfg, rp, params, x = _moe_setup()
    ranks = ServeMesh(1, 1, 0, "gloo", torch.device("cpu"), {})
    tp = MeshContext(TrainView(ranks), cfg, x.shape[0], train=True)
    y, aux = _port(params, cfg, x, ctx.plan_for_mesh(ranks, moe_impl=impl),
                   tp)
    ry, raux = _ref_hierarchical(rcfg, rp, x, 1)
    _assert_y(y, aux, ry, raux)


@pytest.mark.parametrize("impl", ["hierarchical", "shard_map"])
def test_moe_gradients_reach_every_expert(impl):
    """The gradients of sum(y^2) + aux under each layout equal the
    reference's hierarchical layout's, and every expert's reach it."""
    rcfg, cfg, rp, params, x = _moe_setup()
    rplan = ref_ctx.MeshPlan(n_data=2, data_axes=("data",),
                             moe_impl="hierarchical")

    def rloss(p):
        with ref_ctx.use_plan(rplan):
            y, aux = ref_moe.moe_ffn(p, rcfg, jnp.asarray(x))
        return jnp.sum(jnp.square(y)) + aux

    rgrads = jax.grad(rloss)(rp)
    live = {k: ({kk: vv.clone().requires_grad_() for kk, vv in v.items()}
                if isinstance(v, dict) else v.clone().requires_grad_())
            for k, v in params.items()}
    plan = (ctx.MeshPlan(n_data=2, data_axes=("data",),
                         moe_impl="hierarchical")
            if impl == "hierarchical" else
            ctx.plan_for_mesh(MeshShape(2, 2), moe_impl="shard_map"))
    with ctx.use_plan(plan):
        y, aux = moe.moe_ffn(live, cfg, torch.from_numpy(x))
    (torch.sum(torch.square(y)) + aux).backward()
    for key in ("router", "wi_gate", "wi_up", "wo"):
        g = live[key].grad
        assert torch.isfinite(g).all(), key
        np.testing.assert_allclose(g.numpy(), np.asarray(rgrads[key]),
                                   err_msg=key, **GRADS)
    per_expert = live["wi_gate"].grad.abs().flatten(1).amax(dim=1)
    assert (per_expert > 0).all(), per_expert
    for key in ("wi_gate", "wi_up", "wo"):
        np.testing.assert_allclose(live["shared"][key].grad.numpy(),
                                   np.asarray(rgrads["shared"][key]),
                                   err_msg=key, **GRADS)


# -- the plan through the train path ------------------------------------------


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-moe-16b"])
def test_loss_under_the_optimized_plan_matches_plain(arch):
    """The shard_map plan on a one-device mesh leaves the loss as it was,
    as in the reference."""
    a = checks.arch(arch)
    batch = checks.to_torch(checks.fixed_batch(a, 0))
    run = steps.RunConfig(remat="none")
    params = a.params()
    plain, _ = steps.loss_fn(params, a.cfg, batch, run)
    plan = ctx.plan_for_mesh(MeshShape(1, 1), moe_impl="shard_map")
    with ctx.use_plan(plan):
        opt, _ = steps.loss_fn(params, a.cfg, batch, run)
    np.testing.assert_allclose(float(opt), float(plain), **LOSS)


@functools.lru_cache(maxsize=None)
def _ref_moe_loss_and_grads():
    """The reference's deepseek-moe-16b loss and gradients under the
    hierarchical plan at Z = 2 on :func:`checks.fixed_batch` 0, and its
    plain loss."""
    a = checks.arch("deepseek-moe-16b")
    batch = checks.to_jax(checks.fixed_batch(a, 0))
    rrun = ref_steps.RunConfig(remat="none", zero=False)
    rplan = ref_ctx.MeshPlan(n_data=2, data_axes=("data",),
                             moe_impl="hierarchical")

    def vg():  # a function of its own a trace: jit caches by function
        return jax.jit(jax.value_and_grad(
            lambda p, b: ref_steps.loss_fn(p, a.rcfg, b, rrun),
            has_aux=True))

    with ref_ctx.use_plan(rplan):
        (total, _), grads = vg()(a.rparams, batch)
    (plain, _), _ = vg()(a.rparams, batch)
    return float(total), grads, float(plain)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_hierarchical_loss_and_grads_match_the_reference(remat):
    """deepseek-moe-16b's loss and gradients under the hierarchical plan
    at Z = 2, against the reference's under its plan, with and without
    remat."""
    a = checks.arch("deepseek-moe-16b")
    batch = checks.to_torch(checks.fixed_batch(a, 0))
    rtotal, rgrads, plain = _ref_moe_loss_and_grads()
    assert abs(rtotal - plain) > 1e-6  # the layouts differ
    plan = ctx.MeshPlan(n_data=2, data_axes=("data",),
                        moe_impl="hierarchical")
    with ctx.use_plan(plan):
        grads, metrics = steps.loss_and_grads(
            a.params(), a.cfg, batch, steps.RunConfig(remat=remat))
        total, _ = steps.loss_fn(a.params(), a.cfg, batch,
                                 steps.RunConfig(remat="none"))
    np.testing.assert_allclose(float(total), rtotal, rtol=1e-5)
    checks.assert_trees_close(grads, checks.as_port_tree(a, rgrads), "grad",
                              **GRADS)


def test_remat_recompute_keeps_the_forwards_plan():
    """A ``full`` remat's recompute runs in the backward pass; when that
    runs after the caller's ``use_plan`` has closed, it must still take
    the forward's layout: the gradients equal those of ``none``."""
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import tree_leaves, tree_map

    a = checks.arch("deepseek-moe-16b")
    tokens = checks.to_torch(checks.fixed_batch(a, 0))["tokens"]
    plan = ctx.MeshPlan(n_data=2, data_axes=("data",),
                        moe_impl="hierarchical")
    out = {}
    for remat in ("none", "full"):
        live = tree_map(lambda p: p.detach().requires_grad_(True), a.params())
        with ctx.use_plan(plan):
            logits, aux = transformer.forward(live, a.cfg, tokens,
                                              remat=remat)
        loss = logits.square().mean() + aux
        out[remat] = torch.autograd.grad(loss, tree_leaves(live))
    for g, w in zip(out["full"], out["none"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7)
