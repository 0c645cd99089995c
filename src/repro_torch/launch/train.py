"""End-to-end training entry point of the port: config -> state -> resilient
loop (checkpoint/restart, straggler detection) -> metrics.

Port of ``repro/launch/train.py`` on one device:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch gpt2-124m --smoke --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --no-smoke --steps 6 --batch 4 --seq 2048 --remat full

It runs on ``--device cuda`` (the default) or ``cpu``; asking for CUDA
where there is none raises.  The weights come from the port's seeded
init, drawn on the device the job runs on.  Each step's batch comes from
the stateless pipeline (:mod:`repro_torch.data.pipeline`), and the train
step updates params and optimizer state in place (``donate=True``).  With
``--ckpt-dir`` the steps run under the port's
:class:`~repro_torch.distributed.fault_tolerance.ResilientLoop` over its
:class:`~repro_torch.checkpoint.CheckpointStore`, which saves every
``--ckpt-every`` steps and, on a step's fault, restores the newest
checkpoint and replays from it.  The train mesh (``--model-axis`` above
1) and the reference's ``--zero`` (ZeRO sharding of the optimizer state
over the mesh's data axes) come with ROADMAP item 1.18.2: on one device
any other model axis raises :class:`~repro_torch.launch.mesh.MeshShapeError`, as the
reference's host mesh does on a one-device host.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys
import time
from typing import Any, Callable, Dict, Optional

import torch

import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.device import resolve_device
from repro_torch.data import pipeline
from repro_torch.distributed.fault_tolerance import (FaultToleranceConfig,
                                                     ResilientLoop)
from repro_torch.launch.mesh import MeshShapeError
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_mod

log = logging.getLogger("repro_torch.train")


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


def check_mesh(model_axis: int) -> None:
    """Raise unless ``model_axis`` splits one device: a (1, 1) (data,
    model) mesh is the only one the port trains on."""
    if model_axis != 1:
        raise MeshShapeError(
            f"one device, not divisible into a (1/{model_axis}, "
            f"{model_axis}) (data, model) mesh; the train mesh comes with "
            f"ROADMAP item 1.18.2", shape=(1, model_axis), n_devices=1)


def job_configs(job: TrainJob):
    """(cfg, shape, run) of ``job``."""
    cfg = (configs.get_smoke_config(job.arch) if job.smoke
           else configs.get_config(job.arch))
    shape = ShapeConfig("train_job", job.seq, job.batch, "train")
    opt_cfg = adamw.AdamWConfig(lr=job.lr, total_steps=max(job.steps, 1))
    run = steps_mod.RunConfig(remat=job.remat, microbatches=job.microbatches,
                              opt=opt_cfg)
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


def train(job: TrainJob, *, hook: Optional[Callable[[int], None]] = None
          ) -> Dict[str, Any]:
    """Run ``job``: {"restarts", "straggler_events", "final_metrics",
    "history" (the logged steps' metrics as floats), "state", "cfg"}.
    ``hook`` is called with each step's index before the step runs; it may
    raise to inject a fault, which the resilient loop (with ``ckpt_dir``)
    survives."""
    check_mesh(job.model_axis)
    dev = resolve_device(job.device)
    cfg, shape, run = job_configs(job)
    data_cfg = pipeline.DataConfig(seed=job.seed)
    train_step = steps_mod.make_train_step(cfg, run, donate=True)
    metrics_hist = []

    def step_fn(step: int, state):
        if hook is not None:
            hook(step)
        batch = pipeline.global_batch(cfg, shape, data_cfg, step)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt, metrics = train_step(state["params"], state["opt"],
                                          batch)
        if step % job.log_every == 0 or step == job.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            metrics_hist.append(m)
            log.info("step %d loss %.4f gnorm %.3f", step, m["loss"],
                     m["grad_norm"])
        return {"params": params, "opt": opt}

    if job.ckpt_dir:
        store = CheckpointStore(job.ckpt_dir)
        ft = FaultToleranceConfig(checkpoint_every=job.ckpt_every,
                                  async_save=True)
        # the loop builds the state (and on a restart drops the failed one
        # before restoring), so the device never holds two copies
        loop = ResilientLoop(store, ft, step_fn,
                             lambda: init_state(job, cfg, run), device=dev)
        out = loop.run(job.steps)
        state = out["state"]
        result = {"restarts": out["restarts"],
                  "straggler_events": out["straggler_events"]}
    else:
        state = init_state(job, cfg, run)
        for step in range(job.steps):
            state = step_fn(step, state)
        result = {"restarts": 0, "straggler_events": 0}

    result.update({
        "final_metrics": metrics_hist[-1] if metrics_hist else {},
        "history": metrics_hist,
        "state": state,
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
        check_mesh(job.model_axis)
    except MeshShapeError as e:
        print(f"launch.train: {e}", file=sys.stderr)
        return 2
    t0 = time.time()
    out = train(job)
    print(f"done in {time.time() - t0:.1f}s: {out['final_metrics']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
