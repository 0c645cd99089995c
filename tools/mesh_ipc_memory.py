#!/usr/bin/env python3
"""Card memory that a mesh check leaves allocated in the process that ran
it, for one checkout.

    python3 tools/mesh_ipc_memory.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` runs (by default
this checkout's), so that two checkouts can be compared in one run on one
card.  The check is ``serve.mesh_check.run_check`` on the 1x2 and 2x2
meshes, serving qwen3-1.7b at full width cut to 4 layers, in float32, 3
requests of 8 new tokens: its parameters are drawn once on the card in
this process and reach the ranks through CUDA IPC.  Once the check has
returned and the garbage is collected, those parameters should be gone.
Prints one JSON line (the bytes allocated before and after, and the
check's verdict and seconds), then the card's name and power limit.
Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mesh_ipc_memory: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.core.device import resolve_device
    from repro_torch.serve import mesh_check

    resolve_device("cuda")
    cfg = dataclasses.replace(configs.get_config("qwen3-1.7b"), n_layers=4,
                              param_dtype="float32", compute_dtype="float32")
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    verdict = mesh_check.run_check(
        ("1x2", "2x2"), (("qwen3", "qwen3-1.7b", {"config": cfg}),),
        requests=3, max_new=8, device="cuda", timeout=600)
    seconds = time.perf_counter() - t0
    gc.collect()
    cs.emit({"label": args.label, "src": args.src, "ok": verdict["ok"],
             "seconds": seconds, "allocated_before": before,
             "allocated_after": torch.cuda.memory_allocated()})
    print(cs.nvidia_smi(), flush=True)
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
