"""Quickstart: build a model, take a train step, and run the paper's
vectorization analysis on the step — the 60-second tour, the port's
counterpart of the reference's ``examples/quickstart.py``.

The analysis is ONE call: wrap the step in a ``Workload`` and ``analyze``
it on the H100 model; a recording of the operators one run of the step
dispatches (forward, backward and the AdamW update, on CPU copies of the
arguments) -> Eq. 1 metrics -> adapted roofline (Eq. 2) -> Fig. 8
decision tree all run inside the pipeline.  Recorded events persist in
the content-addressed artifact store, so a second run against the same
store records nothing.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu --store-dir /tmp/q
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional

import torch

import repro_torch.configs as configs
from repro_torch.analysis import (
    DEFAULT_STORE, ArtifactCache, ArtifactStore, Workload, analyze,
)
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import hw
from repro_torch.core.device import resolve_device
from repro_torch.data import pipeline
from repro_torch.optim import adamw
from repro_torch.train import steps as steps_mod


def run(device: Any = "cuda", store_dir: Optional[str] = None) -> Dict:
    """The tour on ``device``, events kept in the store at ``store_dir``
    (default: the shared default store); returns the step's loss and grad
    norm, the analysis and the cache's recordings and store hits."""
    dev = resolve_device(device)
    # 1. pick an architecture (every arch of the port is selectable by name)
    cfg = configs.get_smoke_config("qwen3-1.7b")
    print(f"arch={cfg.name}  family={cfg.family}  params~{cfg.param_count()/1e6:.1f}M")

    # 2. one training step
    run_cfg = steps_mod.RunConfig(remat="none")
    params = steps_mod.init_model(cfg, seed=0, device=dev)
    opt = adamw.init_opt_state(params, run_cfg.opt)
    shape = ShapeConfig("quickstart", 64, 4, "train")
    batch = {k: torch.from_numpy(v.copy()).to(dev) for k, v in
             pipeline.global_batch(cfg, shape, pipeline.DataConfig(), 0).items()}
    train_step = steps_mod.make_train_step(cfg, run_cfg)
    params, opt, metrics = train_step(params, opt, batch)
    loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])
    print(f"step 0: loss={loss:.4f} grad_norm={grad_norm:.3f}")

    # 3. the paper's analysis, in one call on the H100 model
    cache = ArtifactCache(store=ArtifactStore(store_dir) if store_dir
                          else DEFAULT_STORE)
    wl = Workload(name="train_step", fn=train_step, args=(params, opt, batch),
                  dtype="bf16")
    result = analyze(wl, chip=hw.H100, cache=cache)

    ev = result.events
    print("\nrecorded-step events (forward, backward and update):")
    print(f"  flops={ev.flops:.3e}  mxu_share={ev.mxu_fraction:.2%}  "
          f"traffic={ev.bytes_accessed:.3e}B")
    rl = result.roofline
    print(f"\nadapted roofline on {result.chip} (paper Eq. 2):")
    print(f"  VB={result.vb:.0f}  AI_IRR={rl.ai_irr:.1f}  "
          f"AI_IRV={rl.ai_irv:.1f} flop/B  AI={result.ai:.3g} ({result.bound})")
    print(f"\ndecision tree (paper Fig. 8): Class {int(result.perf_class)} "
          f"— {result.perf_class.describe()}")
    print(f"  {result.decision.rationale}")
    print("\n" + result.table())

    # 4. events persisted by fingerprint: a re-run against the same store
    # loads them instead of recording the step again
    print(f"\n[analysis: {cache.compiles} recordings, "
          f"{cache.store_hits} store hits; store at {cache.store.cache_dir}]")
    return {"loss": loss, "grad_norm": grad_norm, "analysis": result,
            "recordings": cache.compiles, "store_hits": cache.store_hits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device the train step runs on")
    ap.add_argument("--store-dir", default=None,
                    help="artifact store directory (default: the shared "
                         "store under $REPRO_ARTIFACT_DIR)")
    args = ap.parse_args(argv)
    run(args.device, args.store_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
