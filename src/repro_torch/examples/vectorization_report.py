"""The paper's methodology as a user-facing tool: point it at ANY PyTorch
function and get the full SVE-style vectorization report — counters from
a recording of the operators one run dispatches, VB / R_ins, adapted
roofline placement, and the Fig. 8 decision tree — for the Grace-class
CPU model, the TPU target and the H100.

The port's counterpart of the reference's
``examples/vectorization_report.py``, with the same five workloads; the
Python loop of 8 ``tanh(c @ c)`` stands for the reference's ``lax.scan``
(an eager run records every iteration).  All wiring goes through the
unified API: each function is a ``Workload`` without an analytic model,
and ONE ``analyze_sweep`` runs over the whole set.  The sweep fans
(workload x chip) cells over a thread pool (``jobs=4``) while the
single-flight ArtifactCache keeps recordings at one per workload, and the
persistent store makes a second run of this script record nothing at all.
Each cell's ROI is timed on ``--device``.  The inputs are drawn from
numpy's seeded generator.

    PYTHONPATH=src python -m repro_torch.examples.vectorization_report [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from repro_torch.analysis import (
    DEFAULT_STORE, ArtifactCache, Workload, analyze_sweep, format_table,
)
from repro_torch.core import hw

CHIPS = (hw.GRACE_CORE, hw.TPU_V5E, hw.H100)


def _scanned(x: torch.Tensor) -> torch.Tensor:
    # eight layers of one body: the reference's lax.scan, unrolled
    for _ in range(8):
        x = torch.tanh(x @ x)
    return x


def build_workloads(seed: int = 0, n: int = 512) -> List[Workload]:
    """The reference example's five workloads, on CPU tensors drawn from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal((n, n), dtype=np.float32))
    # pointer chasing: the SpMV pattern
    idx = torch.from_numpy(rng.integers(0, n * n, (n * n,)))
    flat = a.reshape(-1)
    return [
        Workload(name="gemm-512", fn=lambda x, y: x @ y, args=(a, b)),
        Workload(name="stream-triad", fn=lambda x, y: x + 3.0 * y,
                 args=(a, b)),
        Workload(name="gather-reduce", fn=lambda x, i: torch.take(x, i).sum(),
                 args=(flat, idx)),
        Workload(name="scan-8-layers", fn=_scanned, args=(a,)),
        # FFT: not vectorizable across lanes (the paper's FFTW Class-1 case)
        Workload(name="fft2d", fn=lambda x, _: torch.fft.fft2(x).abs(),
                 args=(a, b)),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="device each cell's ROI is timed on")
    args = ap.parse_args(argv)
    wls = build_workloads()
    cache = ArtifactCache(store=DEFAULT_STORE)
    results = analyze_sweep(wls, chips=CHIPS, cache=cache, jobs=4,
                            time_roi=True, device=args.device)

    per_chip = len(CHIPS)
    for i, wl in enumerate(wls):
        ev = results[i * per_chip].events
        print(f"\n### {wl.name}")
        print(f"  flops={ev.flops:.3e}  traffic={ev.bytes_accessed:.3e}B  "
              f"gather={ev.gather_bytes:.3e}B  vec_frac={ev.vectorizable_fraction:.2%} "
              f"mxu_share={ev.mxu_fraction:.2%}")
        print(f"  counter validation: structural flops {ev.flops:.3e} vs "
              f"raw FlopCounterMode {ev.xla_raw_flops:.3e} "
              f"(loop trip counts: {ev.while_trip_counts or 'none, unrolled'})")
        print(format_table(results[i * per_chip:(i + 1) * per_chip]))

    print(f"\n[{len(results)} cells: {cache.compiles} recordings, "
          f"{cache.store_hits} store hits, {cache.hits} cache hits — "
          f"store at {cache.store.cache_dir}]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
