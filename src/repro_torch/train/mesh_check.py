"""Train steps on several meshes of one spawn of ranks, for the checks that
hold a mesh step to the one-device step.

``run_jobs`` runs on every rank of a spawned mesh
(:func:`repro_torch.launch.mesh.spawn`) and carries each job's sub-meshes
(1x1, 2x1, 1x2, 2x2 over the first ranks of the spawn) as subgroups, so a
check pays the ranks' start once.  A job is a dict:

* ``{"kind": "steps", ...}`` (:func:`run_steps`): the reference's
  parameter tree (numpy, its layout) through ``steps.params_from_numpy``
  (``tree``) or the port's seeded init (``seed``: each rank draws it on
  its device a block at a time, ``steps.init_shards``), fixed global
  batches, a
  ``RunConfig``, the mesh shapes and ZeRO settings to run and the MoE
  layout (``moe_impl``); it returns, for each (shape, zero), each step's
  metrics and host-clock ms, the MoE layers' dropped assignments summed
  over the data ranks, the collectives' counters, the optimizer state's
  bytes and the peak allocated bytes on rank 0 while it built its state
  and over the steps, and either the full
  parameters and optimizer state after the steps (numpy, the port's
  layout) or, with ``one_rank``, each kind's largest difference
  from the one-rank step's (no mesh; run first on rank 0, whose final
  params, ``m`` and ``v`` every rank reads in place) and whether every
  leaf is within ``tol``, read on every rank from its own shards; and,
  where both ZeRO settings ran, whether they left the same bits (every
  rank's digest of its state, its ZeRO shards of it).
* ``{"kind": "moe_layer", ...}`` (:func:`run_moe_layer`): one MoE layer
  of the reference's parameters over a global input on each mesh shape,
  in the plan's layout: its output gathered over ``data``, its aux and
  its dropped assignments.
* ``{"kind": "train", "job": TrainJob, "mesh": "DxM", ...}``: the
  trainer (:func:`repro_torch.launch.train.train_on`, what
  ``launch.train.train`` runs on each rank it spawns) on that sub-mesh,
  with an optional fault ``hook``, ``data_cfg`` and ``keep_state``; rank
  0's result with its state, if kept, as numpy.

Results come back from the spawn's rank 0, which is rank 0 of every
sub-mesh, as numpy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.data import pipeline
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed import sharding
from repro_torch.distributed.tensor_parallel import TrainView
from repro_torch.launch.mesh import make_train_mesh, parse_mesh
from repro_torch.models import layers, moe
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import steps


def run_jobs(world, jobs: List[Dict[str, Any]], threads: int = 0
             ) -> Dict[str, Any]:
    """Every job on this rank of ``world``: {job name: result} on rank 0.
    ``threads`` above 0 sets this rank's CPU threads (one makes a CPU
    step repeatable bit for bit)."""
    if threads:
        torch.set_num_threads(threads)
    out = {}
    for job in jobs:
        job = dict(job)
        name, kind = job.pop("name"), job.pop("kind")
        fn = {"steps": run_steps, "moe_layer": run_moe_layer,
              "train": _run_train}[kind]
        out[name] = fn(world, **job)
    return out


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy() if torch.is_tensor(t)
                    else t, tree)


def _sub_mesh(world, shape: str):
    d, m = parse_mesh(shape)
    return make_train_mesh(d, m, device=world.device,
                           ranks=range(d * m))


def _run_train(world, *, job, mesh: str, hook=None, data_cfg=None,
               keep_state: bool = True):
    from repro_torch.launch.train import train_on

    sub = _sub_mesh(world, mesh)
    if sub is None:
        return None
    out = train_on(sub, job, hook=hook, data_cfg=data_cfg,
                   keep_state=keep_state)
    out.pop("cfg")
    if out["state"] is not None:
        out["state"] = _numpy(out["state"])
    return out


def run_steps(world, *, cfg, batches, run, tree=None, seed=None,
              shapes=("2x1",), zeros=(True, False), moe_impl: str = "global",
              one_rank: bool = False, tol=None, zero_shapes=None
              ) -> Dict[Any, Any]:
    """The train step of ``cfg`` from the reference's parameters ``tree``
    (or, with ``seed``, the port's seeded init, which each rank draws on
    its device and cuts) over ``batches`` on each mesh shape and ZeRO
    setting (``zero_shapes``, where given, the shapes that run both
    settings; the others run the first); see the module docstring.

    ``one_rank`` runs the one-rank step (no mesh) first, on the spawn's
    rank 0 from the same init and batches: its metrics a step come back
    as ``"one_rank"``, and every rank holds its shards after each mesh
    run to that step's final params, ``m`` and ``v`` within ``tol``
    (rank 0's tensors, which the others open through CUDA IPC on a
    card)."""
    results: Dict[Any, Any] = {}
    t_job = time.perf_counter()
    host = None if tree is None else steps.params_from_numpy(tree, cfg,
                                                             "cpu")

    def draw(dev):
        """The full init on ``dev``, for the one-rank step."""
        if host is not None:
            return tree_map(lambda t: t.to(dev, copy=True), host)
        return steps.init_model(cfg, seed=seed, device=dev, draw_device=dev)

    def init(layout, dev):
        """This rank's {"params", "opt"}: the reference's tree cut, or the
        seeded init drawn and cut a block at a time."""
        if host is None:
            return steps.init_shards(cfg, layout, run.opt, seed=seed,
                                     device=dev)
        params = layout.cut_params(host, dev)
        return {"params": params,
                "opt": layout.init_state(params, run.opt, dev)}

    ref = None
    if one_rank:
        t0 = time.perf_counter()
        history, ref = _one_rank(world, cfg, draw, batches, run)
        results["one_rank"] = history
        results["one_rank_s"] = time.perf_counter() - t0
    for shape in shapes:
        sub = _sub_mesh(world, shape)
        digests = {}
        both = zero_shapes is None or shape in zero_shapes
        for zero in (zeros if both else zeros[:1]):
            if sub is None:
                continue
            out = _steps_on(sub, cfg, init, batches,
                            dataclasses.replace(run, zero=zero), moe_impl,
                            ref, tol, digests)
            results[(shape, zero)] = out
            if sub.device.type == "cuda":
                torch.cuda.empty_cache()
        if len(digests) == 2:
            same = torch.tensor(float(digests[True] == digests[False]),
                                device=sub.device)
            same = -float(sub.max(sub.max(-same, "data"), "model"))
            if sub.rank == 0:
                results[(shape, "zero_bit_equal")] = same == 1.0
        del sub  # and with it the buffers its ranks shared
        _release(world)
    del ref  # every rank lets go of rank 0's tensors first
    _release(world)
    results["seconds"] = time.perf_counter() - t_job
    return results if world.rank == 0 else None


def _release(world) -> None:
    """Free what every rank of ``world`` let go of: the card memory a rank
    shared with the others (CUDA IPC) is reclaimed once they all dropped
    it, so every rank collects its cycles, then waits for the others."""
    import gc

    import torch.distributed as dist

    gc.collect()
    dist.barrier()
    if world.device.type == "cuda":
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()


def _one_rank(world, cfg, draw, batches, run):
    """(rank 0's one-rank metrics a step, every rank's handle on its final
    {"params", "opt": {"m", "v"}}); see :func:`run_steps`."""
    import torch.distributed as dist

    dev = world.device
    history = state = None
    if world.rank == 0:
        params = draw(dev)
        opt = adamw.init_opt_state(params, run.opt)
        step = steps.make_train_step(cfg, run, donate=True)
        history = []
        for batch in batches:
            params, opt, m = step(params, opt, {
                k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in batch.items()})
            history.append({k: float(v) for k, v in m.items()})
        state = {"params": params, "opt": {"m": opt["m"], "v": opt["v"]}}
        del params, opt, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    payload = None
    if world.rank == 0:
        if dev.type == "cuda":
            from torch.multiprocessing.reductions import reduce_tensor

            torch.cuda.synchronize(dev)
            leaves = [reduce_tensor(t)[1] for t in tree_leaves(state)]
        else:
            leaves = [t.numpy() for t in tree_leaves(state)]
        payload = (tree_map(lambda _: None, state), leaves)
    every = [None] * world.size
    dist.all_gather_object(every, payload)
    if world.rank == 0:
        return history, state
    skeleton, leaves = every[0]
    if dev.type == "cuda":
        from torch.multiprocessing.reductions import rebuild_cuda_tensor

        it = iter(rebuild_cuda_tensor(*a) for a in leaves)
    else:
        it = iter(torch.from_numpy(a) for a in leaves)
    return history, tree_map(lambda _: next(it), skeleton)


def _digest(tree) -> List[int]:
    """Two int64 sums a leaf of its bits read as int32 (plain, and
    weighted by position): equal trees give equal digests; two that
    differ in any bit, all but surely not."""
    out = []
    for t in tree_leaves(tree):
        bits = t.detach().contiguous().view(-1)
        if bits.element_size() == 2:
            bits = bits.view(torch.int16).to(torch.int64)
        else:
            bits = bits.view(torch.int32).to(torch.int64)
        pos = torch.arange(1, bits.numel() + 1, device=bits.device)
        out += [int(bits.sum()), int((bits * pos).sum())]
    return out


def _compare(layout, params, opt, ref, tol, dev) -> Dict[str, Any]:
    """Each kind's largest |got - want| of this rank's shards against the
    reference state's same shards (cut here, a leaf at a time), and
    whether every element is within ``tol``; the worst over the mesh."""
    rtol, atol = tol["rtol"], tol["atol"]
    worst = {}
    ok = True
    want = {"params": tree_leaves(ref["params"])}
    got = {"params": tree_leaves(params)}
    specs = {"params": tree_leaves(layout.p_specs)}
    for key in ("m", "v"):
        want[key] = tree_leaves(ref["opt"][key])
        got[key] = tree_leaves(opt[key])
        specs[key] = tree_leaves(layout.o_specs)
    coords = {name: layout.mesh.axis_index(name)
              for name in layout.mesh.axis_names}
    for key in want:
        err = 0.0
        for g, w, spec in zip(got[key], want[key], specs[key]):
            w = sharding.local_shard(w, spec, layout.mesh, coords).to(
                dev, torch.float32)
            d = (g.float() - w).abs()
            err = max(err, float(d.max()) if d.numel() else 0.0)
            ok = ok and bool((d <= atol + rtol * w.abs()).all())
        worst[key] = err
    vec = torch.tensor([worst[k] for k in want] + [0.0 if ok else 1.0],
                       device=dev)
    vec = layout.mesh.max(layout.mesh.max(vec, "data"), "model")
    out = {f"max_abs_err_{k}": float(v) for k, v in zip(want, vec)}
    out["within_tol"] = float(vec[-1]) == 0.0
    return out


def _steps_on(mesh, cfg, init, batches, run, moe_impl, ref, tol, digests):
    dev = mesh.device
    cuda = dev.type == "cuda"
    shapes = steps.param_shapes(cfg, device=dev)
    step = steps.make_train_step(cfg, run, mesh, shapes=shapes, donate=True)
    layout = step.layout
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    state = init(layout, dev)
    params, opt = state["params"], state["opt"]
    del state
    init_peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    d = mesh.axis_size("data")
    history, ms = [], []
    sync = torch.cuda.synchronize if cuda else None
    if sync is not None:
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    before = dict(mesh.comm.counters())
    plan = mesh_ctx.plan_for_mesh(mesh, moe_impl=moe_impl)
    with mesh_ctx.use_plan(plan), moe.record_drops() as drops:
        for batch in batches:
            local = pipeline.rank_rows(batch, mesh.axis_index("data"), d,
                                       run.microbatches)
            local = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                     for k, v in local.items()}
            if sync is not None:
                sync()
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, local)
            if sync is not None:
                sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            history.append({k: float(v) for k, v in metrics.items()})
    counters = {k: v - before[k] for k, v in mesh.comm.counters().items()}
    dropped = sum(int(t) for t in drops) if drops else 0
    dropped = int(mesh.sum(torch.tensor(dropped, device=dev), "data"))
    out = {"history": history, "ms": ms, "dropped": dropped,
           "counters": counters, "opt_bytes": adamw.state_bytes(opt),
           "opt_bytes_without_zero": layout.block_state_bytes(params, opt)}
    if cuda:  # the peaks, and what the rank held before the steps
        out["init_peak_bytes"] = init_peak
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out["held_before_bytes"] = held
    zlay = layout if run.zero else adamw.ShardLayout(shapes, mesh, zero=True)
    state = {k: opt[k] if run.zero else zlay.shards(opt[k])
             for k in ("m", "v", "master") if k in opt}
    digests[run.zero] = (_digest(params) + _digest(state), repr(history))
    if ref is not None:
        out.update(_compare(layout, params, opt, ref, tol, dev))
    else:
        full_p = layout.full_params(params)
        full_o = layout.full_state(opt)
        out["params"], out["opt"] = _numpy(full_p), _numpy(full_o)
    return out if mesh.rank == 0 else None


def run_moe_layer(world, *, cfg, tree, x, shapes=("2x1",),
                  moe_impl: str = "global") -> Dict[Any, Any]:
    """``moe.moe_ffn`` with the reference's MoE parameters ``tree`` (its
    ``init_moe``, numpy) over the global input ``x`` (B, S, d) on each
    mesh shape, in the ``moe_impl`` layout: {shape: {"y" (gathered over
    ``data``), "aux", "dropped"}} on rank 0."""
    out: Dict[Any, Any] = {}
    for shape in shapes:
        mesh = _sub_mesh(world, shape)
        if mesh is None:
            continue
        dev = mesh.device
        full = tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                        tree)
        params = sharding.train_params({"moe": full}, mesh)["moe"]
        params = tree_map(lambda t: t.to(dev).contiguous(), params)
        d = mesh.axis_size("data")
        xl = pipeline.rank_rows({"x": x}, mesh.axis_index("data"), d)["x"]
        xl = torch.from_numpy(np.ascontiguousarray(xl)).to(dev)
        tp = layers.MeshContext(TrainView(mesh), cfg, xl.shape[0],
                                train=True)
        plan = mesh_ctx.plan_for_mesh(mesh, moe_impl=moe_impl)
        with torch.no_grad(), mesh_ctx.use_plan(plan), \
                moe.record_drops() as drops:
            y, aux = moe.moe_ffn(params, cfg, xl, tp)
        dropped = mesh.sum(sum(drops).reshape(()), "data")
        y = mesh.gather(y, "data", 0)
        if mesh.rank == 0:
            out[shape] = {"y": y.cpu().numpy(), "aux": float(aux),
                          "dropped": int(dropped)}
    return out
