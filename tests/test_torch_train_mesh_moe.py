"""MoE's layouts across a train mesh of ranks against the reference:
deepseek-moe's smoke config (8 experts, top 2, capacity factor 1.25) on a
(4, 16) batch where capacity binds.

* The global layout (the reference's trainer: no plan, one routing group
  over the global batch) equals the reference's no-plan ``moe_ffn`` and
  its one-device train step on 1x1, 2x1, 1x2 and 2x2, ZeRO on and off bit
  for bit, with the same dropped assignments (above 0) on every shape.
* Without the exchange of per-expert counts between data ranks the layer
  would differ: routed per rank at the global capacity, a rank's
  assignments take slots another rank's hold.
* The hierarchical and shard_map layouts route each data rank's tokens
  with capacity of their own, equal to the reference's hierarchical
  layout at Z = 2; there the hierarchical layout differs from the
  global one.

One module-scoped spawn of 2x2 gloo ranks runs the mesh jobs.  y rtol
1e-5 and atol 1e-5, aux rtol 1e-6 (``tests/test_torch_mesh_plan.py``'s
bounds); the steps' state rtol 1e-4 and atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as ref_configs  # noqa: E402
from repro.configs.base import ShapeConfig as RefShape  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.distributed import context as ref_ctx  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.train import steps as ref_steps  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
import torch_threads  # noqa: E402
import torch_train_checks as checks  # noqa: E402
import torch_train_mesh_checks as mc  # noqa: E402

torch_threads.use_threads(2)

ARCH = "deepseek-moe-16b"
#: (B, S): capacity binds for the global batch and for each data rank
SHAPE = (4, 16)
Y = dict(rtol=1e-5, atol=1e-5)
AUX = dict(rtol=1e-6, atol=0)
ALL_SHAPES = ("1x1",) + mc.SHAPES
HIER_SHAPES = ("2x1", "2x2")


def _layer_inputs():
    a = checks.arch(ARCH)
    rp = ref_moe.init_moe(jax.random.PRNGKey(0), a.rcfg, jnp.float32)
    x = np.random.default_rng(1).standard_normal(
        SHAPE + (a.cfg.d_model,)).astype(np.float32)
    return a, rp, x


@pytest.fixture(scope="module")
def runs():
    a, rp, x = _layer_inputs()
    tree = jax.tree.map(np.asarray, rp)
    jobs = [{"name": f"layer-{impl}", "kind": "moe_layer", "cfg": a.cfg,
             "tree": tree, "x": x, "moe_impl": impl,
             "shapes": ALL_SHAPES if impl == "global" else HIER_SHAPES}
            for impl in ("global", "hierarchical", "shard_map")]
    jobs.append(mc.steps_job("global", ARCH, seq=SHAPE[1], batch=SHAPE[0],
                             shapes=ALL_SHAPES))
    for impl in ("hierarchical", "shard_map"):
        jobs.append(mc.steps_job(impl, ARCH, seq=SHAPE[1], batch=SHAPE[0],
                                 shapes=HIER_SHAPES, zeros=(True,),
                                 moe_impl=impl))
    data_cfg = pipeline.with_role_hashes(pipeline.DataConfig())
    for zero in (True, False):  # the CLI's job: --mesh 2x2 [--no-zero]
        jobs.append({"name": f"cli-{zero}", "kind": "train", "mesh": "2x2",
                     "job": _cli_job(zero), "data_cfg": data_cfg})
    return mc.spawn_jobs(jobs)


def _cli_job(zero):
    return launch.TrainJob(arch=ARCH, smoke=True, steps=2, batch=SHAPE[0],
                           seq=SHAPE[1], device="cpu", mesh="2x2",
                           zero=zero, log_every=1)


def _ref_layer(plan=None):
    a, rp, x = _layer_inputs()
    with ref_ctx.use_plan(plan or ref_ctx.MeshPlan()):
        y, aux = jax.jit(lambda p, x: ref_moe.moe_ffn(p, a.rcfg, x))(
            rp, jnp.asarray(x))
    return np.asarray(y), float(aux)


def _hier_plan():
    return ref_ctx.MeshPlan(n_data=2, data_axes=("data",),
                            moe_impl="hierarchical")


@pytest.fixture(scope="module")
def refs():
    return {"global": mc.ref_run(ARCH, seq=SHAPE[1], batch=SHAPE[0]),
            "hierarchical": mc.ref_run(ARCH, seq=SHAPE[1], batch=SHAPE[0],
                                       plan=_hier_plan())}


# -- the global layout ----------------------------------------------------------


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_global_layer_equals_the_reference_no_plan_moe(runs, shape):
    got = runs["layer-global"][shape]
    y, aux = _ref_layer()
    np.testing.assert_allclose(got["y"], y, **Y)
    np.testing.assert_allclose(got["aux"], aux, **AUX)


def test_capacity_binds_and_drops_equal_on_every_shape(runs):
    drops = {s: runs["layer-global"][s]["dropped"] for s in ALL_SHAPES}
    assert drops["1x1"] > 0
    assert len(set(drops.values())) == 1, drops
    steps = {k: v["dropped"] for k, v in runs["global"].items()
             if isinstance(v, dict)}
    assert min(steps.values()) > 0 and len(set(steps.values())) == 1, steps


@pytest.mark.parametrize("shape", ALL_SHAPES)
@pytest.mark.parametrize("zero", [True, False], ids=["zero", "no-zero"])
def test_global_step_equals_the_reference_step(runs, refs, shape, zero):
    mc.assert_equals_the_reference(runs["global"][(shape, zero)],
                                   refs["global"], ARCH)


@pytest.mark.parametrize("shape", ALL_SHAPES)
def test_global_step_zero_on_equals_off_bit_for_bit(runs, shape):
    mc.assert_bit_equal(runs["global"][(shape, True)],
                        runs["global"][(shape, False)])
    assert runs["global"][(shape, "zero_bit_equal")] is True


def test_without_the_count_exchange_the_layer_would_differ(runs):
    """Each data rank of a 2x1 mesh routing its rows alone at the global
    capacity (no offsets from the ranks before it) keeps assignments the
    global layout drops: the layer's output parts from the reference's,
    which the exchanged counts match."""
    a, rp, x = _layer_inputs()
    params = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()
              if k != "shared"}
    params["shared"] = {k: torch.from_numpy(np.array(v))
                        for k, v in rp["shared"].items()}
    m = a.cfg.moe
    C = moe._capacity(m, SHAPE[0] * SHAPE[1])
    ys, kept = [], 0
    for r in range(2):
        xr = torch.from_numpy(x[2 * r:2 * r + 2]).reshape(1, -1, x.shape[-1])
        gates, idx, _ = moe._route(params, m, xr)
        buf, slot, keep = moe._dispatch(m, xr, idx, C)
        out = moe._expert_gemms(params, buf, xr.dtype)
        y = moe._combine(out, slot, keep, gates, m.top_k, xr.dtype)
        ys.append((y + moe._shared_experts(params, xr))[0])
        kept += int(keep.sum())
    alone = torch.cat(ys).reshape(x.shape).numpy()
    y_ref, _ = _ref_layer()
    total = SHAPE[0] * SHAPE[1] * m.top_k
    assert kept > total - runs["layer-global"]["2x1"]["dropped"]
    assert np.abs(alone - y_ref).max() > 1e-2
    np.testing.assert_allclose(runs["layer-global"]["2x1"]["y"], y_ref, **Y)


# -- the per-rank layouts ---------------------------------------------------------


@pytest.mark.parametrize("impl", ["hierarchical", "shard_map"])
@pytest.mark.parametrize("shape", HIER_SHAPES)
def test_per_rank_layer_equals_the_reference_hierarchical(runs, impl, shape):
    got = runs[f"layer-{impl}"][shape]
    y, aux = _ref_layer(_hier_plan())
    np.testing.assert_allclose(got["y"], y, **Y)
    np.testing.assert_allclose(got["aux"], aux, **AUX)


@pytest.mark.parametrize("impl", ["hierarchical", "shard_map"])
@pytest.mark.parametrize("shape", HIER_SHAPES)
def test_per_rank_step_equals_the_reference_hierarchical(runs, refs, impl,
                                                         shape):
    mc.assert_equals_the_reference(runs[impl][(shape, True)],
                                   refs["hierarchical"], ARCH)


def test_the_hierarchical_layout_differs_from_the_global_there(runs, refs):
    """Where capacity binds, the layouts part: the reference's layers and
    steps, and the port's across ranks."""
    y_glob, _ = _ref_layer()
    y_hier, _ = _ref_layer(_hier_plan())
    assert np.abs(y_glob - y_hier).max() > 1e-2
    port_glob = runs["layer-global"]["2x1"]["y"]
    port_hier = runs["layer-hierarchical"]["2x1"]["y"]
    assert np.abs(port_glob - port_hier).max() > 1e-2
    lg = runs["global"][("2x1", True)]["history"][-1]["loss"]
    lh = runs["hierarchical"][("2x1", True)]["history"][-1]["loss"]
    assert lg != lh
    assert refs["global"][2][-1]["loss"] != refs["hierarchical"][2][-1][
        "loss"]


# -- the CLI on 2x2 ------------------------------------------------------------


def test_cli_mesh_run_equals_the_reference_one_device_step(runs):
    """``launch.train --mesh 2x2 --device cpu --arch deepseek-moe-16b
    --smoke --steps 2``: from the port's seeded init (carried into the
    reference's layout) and the pipeline's batches of this process, its
    params equal the reference's one-device train step's, and with
    ``--no-zero`` bit for bit."""
    job = _cli_job(True)
    cfg, shape, run = launch.job_configs(job)
    init = launch.init_state(job, cfg, run)["params"]
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp = jax.tree.map(jnp.asarray, mc.to_reference_tree(
        jax.tree.map(lambda t: t.numpy(), init,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)), cfg))
    rrun = ref_steps.RunConfig(remat="none", zero=False,
                               opt=ref_adamw.AdamWConfig(
                                   lr=job.lr, total_steps=job.steps))
    ro = ref_adamw.init_opt_state(rp, rrun.opt)
    ts = jax.jit(ref_steps.make_train_step(rcfg, rrun))
    for step in range(job.steps):
        batch = ref_pipeline.global_batch(
            rcfg, RefShape("train_job", job.seq, job.batch, "train"),
            ref_pipeline.DataConfig(seed=job.seed), step)
        rp, ro, _ = ts(rp, ro, {k: jnp.asarray(v) for k, v in batch.items()})
    want = checks.as_port_tree(checks.arch(ARCH), rp)
    got = mc._torch_tree(runs["cli-True"]["state"]["params"])
    checks.assert_trees_close(got, want, "params", **mc.STATE)
    off = runs["cli-False"]["state"]
    for a, b in zip(tree_leaves(runs["cli-True"]["state"]), tree_leaves(off)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
