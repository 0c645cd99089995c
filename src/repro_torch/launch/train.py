"""End-to-end training entry point of the port: config -> mesh -> state ->
resilient loop (checkpoint/restart, straggler detection) -> metrics.

Port of ``repro/launch/train.py``:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch gpt2-124m --smoke --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch deepseek-moe-16b --smoke --steps 2 --mesh 2x2 [--no-zero]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --no-smoke --steps 6 --batch 4 --seq 2048 --remat full
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --no-smoke --layers 4 --steps 4 --batch 4 --seq 512 --mesh 2x2

It runs on ``--device cuda`` (the default) or ``cpu``; asking for CUDA
where there is none raises.  The weights come from the port's seeded
init, drawn on the device the job runs on.  Each step's batch comes from
the stateless pipeline (:mod:`repro_torch.data.pipeline`), and the train
step updates params and optimizer state in place (``donate=True``).  With
``--ckpt-dir`` the steps run under the port's
:class:`~repro_torch.distributed.fault_tolerance.ResilientLoop` over its
:class:`~repro_torch.checkpoint.CheckpointStore`, which saves every
``--ckpt-every`` steps and, on a step's fault, restores the newest
checkpoint and replays from it.

``--mesh DxM`` (or ``--model-axis M``, which means ``1xM``; the two may
not disagree) trains on a (data, model) mesh of ``D*M`` ranks, spawned
here (:func:`~repro_torch.launch.mesh.spawn`; on one card they share it
over gloo), as the reference trains on its host mesh: parameters by the
train rules, the optimizer state ZeRO-sharded over ``data`` unless
``--no-zero`` (the same numbers either way), each data rank its rows of
every batch, MoE in the reference's global layout.  A mesh the rules
cannot split raises :class:`~repro_torch.launch.mesh.MeshShapeError`
(exit 2).  Each rank draws the seeded init a block of leaves at a time
and keeps its shards of each, so no rank holds the whole model.  Rank 0
saves checkpoints in the unsharded layout a one-device run saves and
every rank restores its own shard, so one-device and mesh runs resume
from each other's checkpoints.  ``--layers N`` cuts a decoder LM to its
first N layers.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.device import resolve_device
from repro_torch.data import pipeline
from repro_torch.distributed import context as mesh_ctx
from repro_torch.distributed.fault_tolerance import (FaultToleranceConfig,
                                                     ResilientLoop)
from repro_torch.launch.mesh import MeshShape, MeshShapeError, parse_mesh
from repro_torch.models import layers
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_map
from repro_torch.train import steps as steps_mod

log = logging.getLogger("repro_torch.train")

#: seconds a mesh run may take, and any one of its collectives (a rank
#: that dies still stops every rank at once)
RUN_TIMEOUT_S = 7 * 24 * 3600.0
COLLECTIVE_TIMEOUT_S = 1800.0


@dataclasses.dataclass
class TrainJob:
    arch: str = "gpt2-124m"
    smoke: bool = True
    steps: int = 50
    batch: int = 8
    seq: int = 128
    lr: float = 3e-4
    microbatches: int = 1
    remat: str = "none"
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 20
    model_axis: int = 1
    log_every: int = 10
    device: str = "cuda"
    zero: bool = True
    mesh: Optional[str] = None
    layers: Optional[int] = None


def mesh_shape(job: TrainJob) -> Tuple[int, int]:
    """(data, model) of ``job``: its ``--mesh``, or ``1 x --model-axis``;
    raises MeshShapeError where the two disagree."""
    if job.mesh is None:
        return 1, MeshShape(1, job.model_axis).model
    d, m = parse_mesh(job.mesh)
    if job.model_axis not in (1, m):
        raise MeshShapeError(
            f"--mesh {job.mesh} and --model-axis {job.model_axis} name "
            f"different model axes", shape=(d, m))
    return d, m


def check_mesh(job: TrainJob, cfg) -> None:
    """Raise MeshShapeError unless the train rules can lay ``job`` out on
    its mesh: the batch splits into whole microbatches over ``data``, a
    model axis above 1 splits some weight of ``cfg``, and it splits no
    MLA or mamba block only in part."""
    d, m = mesh_shape(job)
    if job.batch % (d * job.microbatches):
        raise MeshShapeError(
            f"batch {job.batch} does not split into {job.microbatches} "
            f"microbatch(es) over a data axis of {d}", shape=(d, m))
    if m == 1:
        return
    try:
        tp = layers.MeshContext(MeshShape(d, m), cfg, job.batch // d,
                                train=True)
    except ValueError as e:
        raise MeshShapeError(str(e), shape=(d, m)) from e
    if not any(tp.qkv_split + (tp.ffn_split, tp.vocab_split,
                               tp.head_split, tp.experts_split,
                               tp.shared_split, tp.mla_split,
                               tp.mamba_split)):
        raise MeshShapeError(
            f"{cfg.name}: a model axis of {m} splits none of its weights",
            shape=(d, m))


def job_configs(job: TrainJob):
    """(cfg, shape, run) of ``job``; ``job.layers`` cuts a decoder LM to
    its first layers."""
    cfg = (configs.get_smoke_config(job.arch) if job.smoke
           else configs.get_config(job.arch))
    if job.layers is not None:
        if cfg.is_encoder_decoder or not 0 < job.layers <= cfg.n_layers:
            raise ValueError(f"--layers {job.layers}: {cfg.name} has "
                             f"{cfg.n_layers} layers, and only a decoder "
                             f"LM's are cut")
        cfg = dataclasses.replace(cfg, n_layers=job.layers)
    shape = ShapeConfig("train_job", job.seq, job.batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=job.lr, total_steps=max(job.steps, 1))
    run = steps_mod.RunConfig(remat=job.remat, microbatches=job.microbatches,
                              zero=job.zero, opt=opt_cfg)
    return cfg, shape, run


def init_state(job: TrainJob, cfg, run) -> Dict[str, Any]:
    """{"params", "opt"}: ``job``'s seeded init, drawn on its device."""
    params = steps_mod.init_model(cfg, seed=job.seed, device=job.device,
                                  draw_device=job.device)
    return {"params": params, "opt": adamw.init_opt_state(params, run.opt)}


def build_state(job: TrainJob):
    """(cfg, shape, run, {"params", "opt"}) of ``job``, on its device."""
    cfg, shape, run = job_configs(job)
    return cfg, shape, run, init_state(job, cfg, run)


def train(job: TrainJob, *, hook: Optional[Callable[[int], None]] = None,
          data_cfg: Optional[pipeline.DataConfig] = None,
          keep_state: bool = True) -> Dict[str, Any]:
    """Run ``job``: {"restarts", "straggler_events", "final_metrics",
    "history" (the logged steps' metrics as floats), "step_ms" (each
    logged step's ms on the host clock, to its metrics on the host),
    "memory" (on CUDA), "collectives" (on a mesh), "state", "cfg"}; see
    :func:`train_on`.  ``hook`` is called with each step's
    index before the step runs; it may raise to inject a fault, which the
    resilient loop (with ``ckpt_dir``) survives.  On a mesh the ranks are
    spawned here, each calls ``hook`` (pickled, as ``job`` is), and
    ``state`` is the full state, gathered on the CPU; the ranks draw this
    process's batches (:func:`~repro_torch.data.pipeline.with_role_hashes`).
    ``keep_state=False`` returns no state (and a mesh gathers none)."""
    cfg, _, _ = job_configs(job)
    check_mesh(job, cfg)
    d, m = mesh_shape(job)
    data_cfg = data_cfg or pipeline.DataConfig(seed=job.seed)
    if d * m == 1:
        return train_on(None, job, hook=hook, data_cfg=data_cfg,
                        keep_state=keep_state)
    from repro_torch.launch.mesh import spawn

    out = spawn(_train_rank, d, m, job, hook,
                pipeline.with_role_hashes(data_cfg), keep_state,
                device=job.device, build=False, timeout=RUN_TIMEOUT_S,
                collective_timeout=COLLECTIVE_TIMEOUT_S)
    if keep_state:
        out["state"] = tree_map(torch.from_numpy, out["state"])
    return out


def _train_rank(mesh, job: TrainJob, hook, data_cfg, keep_state
                ) -> Dict[str, Any]:
    out = train_on(mesh, job, hook=hook, data_cfg=data_cfg,
                   keep_state=keep_state)
    if mesh.rank == 0 and keep_state:
        out["state"] = tree_map(lambda t: t.cpu().numpy(), out["state"])
    return out


class MeshCheckpoints:
    """A :class:`~repro_torch.checkpoint.CheckpointStore` as a rank of a
    train mesh uses it: ``save`` gathers the full (unsharded) state, rank
    0 writes it as a one-device run would, and every rank waits for the
    write; ``restore`` reads the full state and keeps this rank's shard,
    on ``device``."""

    def __init__(self, store: CheckpointStore, mesh,
                 layout: adamw.ShardLayout, template: Dict[str, Any]):
        self.store, self.mesh, self.layout = store, mesh, layout
        self.template = template  # the full state's shapes and dtypes

    def latest_step(self) -> Optional[int]:
        return self.store.latest_step()

    def wait(self) -> None:
        self.store.wait()

    def save(self, step: int, state: Dict[str, Any], *, blocking=True,
             extra=None) -> None:
        full = {"params": self.layout.full_params(state["params"]),
                "opt": self.layout.full_state(state["opt"])}
        if self.mesh.rank == 0:
            self.store.save(step, full, blocking=True, extra=extra)
        del full
        one = torch.zeros((), device=self.mesh.device)
        self.mesh.sum(self.mesh.sum(one, "data"), "model")  # a barrier

    def restore(self, template, *, step=None, device=None):
        step, full, extra = self.store.restore(self.template, step=step,
                                               device="cpu")
        return step, {"params": self.layout.cut_params(full["params"],
                                                       device),
                      "opt": self.layout.cut_state(full["opt"], device)}, \
            extra


def train_on(mesh, job: TrainJob, *,
             hook: Optional[Callable[[int], None]] = None,
             data_cfg: Optional[pipeline.DataConfig] = None,
             keep_state: bool = True) -> Dict[str, Any]:
    """:func:`train` on this process: one device where ``mesh`` is None,
    else this rank of a train mesh (every rank of it calls this), whose
    rank 0 returns the gathered full state.  A rank draws the seeded
    init a block at a time and keeps only its shards of each
    (:func:`~repro_torch.train.steps.init_shards`).

    On CUDA, ``memory`` holds this process's peak allocated bytes while
    it built the state (``init_peak_bytes``) and over the steps after it
    (``step_peak_bytes``), and its optimizer state's bytes
    (``opt_state_bytes``; on a mesh also ``opt_state_bytes_without_zero``
    over its whole parameter blocks); on a mesh ``collectives`` holds its
    collectives' counters over the steps."""
    dev = resolve_device(job.device if mesh is None else mesh.device)
    cuda = dev.type == "cuda"
    cfg, shape, run = job_configs(job)
    data_cfg = data_cfg or pipeline.DataConfig(seed=job.seed)
    metrics_hist, step_ms = [], []
    layout, d, d_index = None, 1, 0
    memory: Dict[str, int] = {}

    if mesh is not None:
        d, d_index = mesh.axis_size("data"), mesh.axis_index("data")
        shapes = steps_mod.param_shapes(cfg, device=dev)
        template = {"params": shapes,
                    "opt": adamw.init_opt_state(shapes, run.opt)}
        train_step = steps_mod.make_train_step(cfg, run, mesh, shapes=shapes,
                                               donate=True)
        layout = train_step.layout
    else:
        train_step = steps_mod.make_train_step(cfg, run, donate=True)

    def init():
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        if mesh is None:
            state = init_state(job, cfg, run)
        else:
            state = steps_mod.init_shards(cfg, layout, run.opt,
                                          seed=job.seed, device=dev)
        if cuda:
            memory["init_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        return state

    def step_fn(step: int, state):
        if hook is not None:
            hook(step)
        t0 = time.perf_counter()
        batch = pipeline.global_batch(cfg, shape, data_cfg, step)
        if mesh is not None:
            batch = pipeline.rank_rows(batch, d_index, d, job.microbatches)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt, metrics = train_step(state["params"], state["opt"],
                                          batch)
        if step % job.log_every == 0 or step == job.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            metrics_hist.append(m)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            log.info("step %d loss %.4f gnorm %.3f", step, m["loss"],
                     m["grad_norm"])
        return {"params": params, "opt": opt}

    before = dict(mesh.comm.counters()) if mesh is not None else None
    plan = (mesh_ctx.MeshPlan() if mesh is None
            else mesh_ctx.plan_for_mesh(mesh))
    with mesh_ctx.use_plan(plan):
        if job.ckpt_dir:
            store = CheckpointStore(job.ckpt_dir)
            ft = FaultToleranceConfig(checkpoint_every=job.ckpt_every,
                                      async_save=mesh is None)
            if mesh is not None:
                store = MeshCheckpoints(store, mesh, layout, template)
            # the loop builds the state (and on a restart drops the failed
            # one before restoring), so the device never holds two copies
            loop = ResilientLoop(store, ft, step_fn, init, device=dev)
            out = loop.run(job.steps)
            state = out["state"]
            result = {"restarts": out["restarts"],
                      "straggler_events": out["straggler_events"]}
        else:
            state = init()
            for step in range(job.steps):
                state = step_fn(step, state)
            result = {"restarts": 0, "straggler_events": 0}
    if cuda:
        memory["step_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        memory["opt_state_bytes"] = adamw.state_bytes(state["opt"])
        if layout is not None:
            memory["opt_state_bytes_without_zero"] = \
                layout.block_state_bytes(state["params"], state["opt"])
        result["memory"] = memory
    if mesh is not None:
        result["collectives"] = {k: v - before[k]
                                 for k, v in mesh.comm.counters().items()}
        if keep_state:
            state = {"params": layout.full_params(state["params"]),
                     "opt": layout.full_state(state["opt"])}
        if mesh.rank != 0:
            state = None
    result.update({
        "final_metrics": metrics_hist[-1] if metrics_hist else {},
        "history": metrics_hist,
        "step_ms": step_ms,
        "state": state if keep_state else None,
        "cfg": cfg,
    })
    return result


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser()
    for f in dataclasses.fields(TrainJob):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            ap.add_argument(name, action=argparse.BooleanOptionalAction,
                            default=f.default)
        elif f.name == "device":
            ap.add_argument(name, choices=["cuda", "cpu"], default=f.default)
        else:
            ap.add_argument(name, type=type(f.default)
                            if f.default is not None else str,
                            default=f.default)
    args = ap.parse_args(argv)
    job = TrainJob(**{f.name: getattr(args, f.name)
                      for f in dataclasses.fields(TrainJob)})
    try:
        check_mesh(job, job_configs(job)[0])
    except MeshShapeError as e:
        print(f"launch.train: {e}", file=sys.stderr)
        return 2
    t0 = time.time()
    out = train(job, keep_state=False)
    print(f"done in {time.time() - t0:.1f}s: {out['final_metrics']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
