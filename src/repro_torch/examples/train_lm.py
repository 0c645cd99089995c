"""End-to-end LM training: the paper's 124M GPT-2 benchmark, with fault
tolerance (checkpoint/restart) and stateless data.

The port's counterpart of the reference's ``examples/train_lm.py``, with
its presets, on ``--device cuda`` (the default) or ``cpu``:

    smoke (default) — the reduced gpt2-124m config, 120 steps: finishes on
                      the CPU in seconds
    full            — the real 124M config, a few hundred steps: the paper's
                      "LLM training" workload

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu] \\
        [--preset full] [--steps N] [--ckpt-dir DIR]

Checkpoints go to ``--ckpt-dir``, or to a fresh temporary directory, so
that a run never resumes from an earlier run's checkpoints unless asked.
"""

from __future__ import annotations

import argparse
import tempfile

from repro_torch.launch.train import TrainJob, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["smoke", "full"], default="smoke")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_lm_")

    if args.preset == "full":
        job = TrainJob(arch="gpt2-124m", smoke=False,
                       steps=args.steps or 300, batch=8, seq=512,
                       remat="full", microbatches=2,
                       ckpt_dir=ckpt_dir, ckpt_every=50, device=args.device)
    else:
        job = TrainJob(arch="gpt2-124m", smoke=True,
                       steps=args.steps or 120, batch=8, seq=64,
                       ckpt_dir=ckpt_dir, ckpt_every=40, device=args.device)

    out = train(job)
    hist = out["history"]
    print(f"\n{'step':>6s} {'loss':>8s} {'grad_norm':>9s} {'lr':>9s}")
    for m in hist:
        print(f"{m['step']:6d} {m['loss']:8.4f} {m['grad_norm']:9.3f} "
              f"{m['lr']:9.2e}")
    first, last = hist[0], hist[-1]
    print(f"\nloss {first['loss']:.4f} -> {last['loss']:.4f} "
          f"({out['restarts']} restarts, "
          f"{out['straggler_events']} straggler events)")
    if not last["loss"] < first["loss"]:
        raise SystemExit("training did not reduce loss")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
