"""Checks shared by the port's train-mesh tests
(``tests/test_torch_train_mesh*.py``): the train step on (data, model)
meshes of spawned gloo ranks held against the reference's one-device
``make_train_step`` (jitted), on the reference's weights and fixed
batches.

Each test module spawns one 2x2 mesh of gloo ranks
(:func:`spawn_jobs`), module-scoped, whose rank 0 sits in every sub-mesh
(1x1, 2x1, 1x2, 2x2) that
:func:`repro_torch.train.mesh_check.run_jobs` carries; the ranks import
no JAX.  Tolerances: every state leaf and metric rtol 1e-4 and atol 1e-5
(2e-4 for the archs with mamba mixers, the SSD bound of
``tests/torch_train_checks.py``); ZeRO on against off bit for bit.
"""

import functools

import jax
import numpy as np
import torch

from repro.optim import adamw as ref_adamw
from repro.train import steps as ref_steps
from repro_torch.launch import mesh as mesh_mod
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import mesh_check, steps
import torch_train_checks as checks

STATE = dict(rtol=1e-4, atol=1e-5)
SHAPES = ("2x1", "1x2", "2x2")
#: seconds a module's spawn may take
TIMEOUT = 600


def spawn_jobs(jobs):
    """Run ``jobs`` (:func:`mesh_check.run_jobs`) on one 2x2 mesh of gloo
    ranks on the CPU: {name: rank 0's result}."""
    return mesh_mod.spawn(mesh_check.run_jobs, 2, 2, jobs, 1, device="cpu",
                          timeout=TIMEOUT, build=False)


def batches(a, n, seq=16, batch=4):
    return [checks.fixed_batch(a, s, seq=seq, batch=batch)
            for s in range(n)]


def steps_job(name, arch, *, n_steps=2, seq=16, batch=4, shapes=SHAPES,
              zeros=(True, False), moe_impl="global", remat="none"):
    a = checks.arch(arch)
    return {"name": name, "kind": "steps", "cfg": a.cfg, "tree": a.tree,
            "batches": batches(a, n_steps, seq, batch),
            "run": steps.RunConfig(remat=remat), "shapes": shapes,
            "zeros": zeros, "moe_impl": moe_impl}


@functools.lru_cache(maxsize=None)
def ref_run(arch, n_steps=2, seq=16, batch=4, plan=None):
    """The reference's one-device train step over the same batches from
    its weights: (params, opt state, metrics per step), the trees as the
    port's; cached, as tests share it."""
    from repro.distributed import context as ref_ctx

    a = checks.arch(arch)
    run = ref_steps.RunConfig(remat="none", zero=False)
    rp = a.rparams
    ro = ref_adamw.init_opt_state(rp, run.opt)
    history = []
    with ref_ctx.use_plan(plan or ref_ctx.MeshPlan()):
        ts = jax.jit(ref_steps.make_train_step(a.rcfg, run))
        for b in batches(a, n_steps, seq, batch):
            rp, ro, m = ts(rp, ro, checks.to_jax(b))
            history.append({k: float(v) for k, v in m.items()})
    return (checks.as_port_tree(a, rp),
            jax.tree.map(np.asarray, ro), history)


def port_opt(arch, ro):
    from repro_torch.optim import adamw

    a = checks.arch(arch)
    return adamw.opt_state_from_numpy(ro, a.cfg, steps.RunConfig().opt,
                                      "cpu")


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return torch.from_numpy(np.asarray(tree))


def assert_equals_the_reference(got, ref, arch, tol=None):
    """A mesh run's params, m, v, master and metrics against the
    reference's (:func:`ref_run`'s output)."""
    tol = tol or checks.state_tol(arch)
    rp, ro, rh = ref
    checks.assert_trees_close(_torch_tree(got["params"]), rp, "params",
                              **tol)
    want = port_opt(arch, ro)
    opt = _torch_tree(got["opt"])
    assert int(opt["step"]) == int(want["step"]) == len(rh)
    for key in ("m", "v", "master"):
        checks.assert_trees_close(opt[key], want[key], key, **tol)
    for h, r in zip(got["history"], rh):
        for key in ("loss", "grad_norm", "moe_aux"):
            np.testing.assert_allclose(h[key], r[key], err_msg=key, **tol)
        assert h["lr"] == r["lr"]


def assert_bit_equal(a, b):
    """Two mesh runs' params, optimizer states and metrics, bit for bit."""
    for key in ("params", "opt"):
        la, lb = tree_leaves(a[key]), tree_leaves(b[key])
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=key)
    assert a["history"] == b["history"]


# -- shapes of the port's parameter tree -------------------------------------


def port_shape_tree(rcfg, cfg):
    """The port's parameter tree of ``cfg`` as ``jax.ShapeDtypeStruct``s,
    from the reference's ``eval_shape`` of its init (no weights drawn):
    layer i of superblock s's slot j unstacked, as ``params_from_numpy``
    lays them out."""
    shapes = jax.eval_shape(lambda k: ref_steps.init_model(k, rcfg),
                            jax.random.PRNGKey(0))

    def row(tree, i):
        return jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape[1:],
                                                           s.dtype), tree)

    if cfg.is_encoder_decoder:
        out = {k: shapes[k] for k in ("embed", "enc_norm", "final_norm",
                                      "lm_head")}
        out["enc_layers"] = [row(shapes["enc_blocks"], i)
                             for i in range(cfg.enc_layers)]
        out["dec_layers"] = [row(shapes["dec_blocks"], i)
                             for i in range(cfg.n_layers - cfg.enc_layers)]
        return out
    out = {k: shapes[k] for k in ("embed", "final_norm", "lm_head")
           if k in shapes}
    out["layers"] = [shapes["first_block"]] if "first_block" in shapes \
        else []
    slots = [f"slot{i}" for i in range(len(cfg.superblock))]
    out["layers"] += [row(shapes["blocks"][slot], s)
                      for s in range(cfg.n_superblocks) for slot in slots]
    return out


def to_reference_tree(tree, cfg):
    """The port's parameter tree of a decoder ``cfg`` (numpy leaves) in
    the reference's layout: layer 0 as ``first_block`` where the config
    has a dense first layer, then each superblock slot's layers stacked
    as ``blocks/slot<i>`` (the inverse of ``params_from_numpy``)."""
    out = {k: v for k, v in tree.items() if k != "layers"}
    layers = list(tree["layers"])
    if cfg.moe is not None and cfg.moe.first_dense:
        out["first_block"] = layers.pop(0)
    n = len(cfg.superblock)

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
        return np.stack([np.asarray(x) for x in xs])

    out["blocks"] = {f"slot{i}": stack(*layers[i::n]) for i in range(n)}
    return out
