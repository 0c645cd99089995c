"""Batched LM serving: the continuous scheduler against the lockstep wave.

The port's counterpart of the reference's ``examples/serve_lm.py``: the
same traffic (qwen3-1.7b smoke config, 10 requests of 3-23 prompt tokens
and 4-11 new tokens from seed 0, 4 slots, ``max_len`` 96, blocks of 16)
is served by the wave scheduler, which admits a wave and runs every slot
to the wave's horizon over a dense cache, and by the continuous one,
which refills a finished slot mid-flight over a paged cache.  The greedy
tokens must be equal, and the continuous scheduler must take no more
fused steps.  The weights are the port's own seeded init.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import repro_torch.configs as configs
from repro_torch.models import transformer
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    cfg = configs.get_smoke_config("qwen3-1.7b")
    params = transformer.init_lm(cfg, seed=0, device=args.device)

    engines = {}
    for scheduler in ("wave", "continuous"):
        engine = ServeEngine(cfg, params, max_batch=4, max_len=96,
                             scheduler=scheduler, block_size=16,
                             device=args.device)
        rng = np.random.default_rng(0)
        n_requests = 10
        for uid in range(n_requests):
            plen = int(rng.integers(3, 24))
            engine.submit(Request(
                uid=uid,
                prompt=rng.integers(0, cfg.vocab, size=plen).astype(np.int32),
                max_new_tokens=int(rng.integers(4, 12)),
            ))
        t0 = time.time()
        done = engine.run_until_drained()
        dt = time.time() - t0
        new_tokens = sum(len(r.generated) for r in done.values())
        print(f"[{scheduler}] served {len(done)} requests / {new_tokens} "
              f"new tokens in {engine.steps} fused steps, {dt:.2f}s "
              f"({new_tokens / dt:.1f} tok/s, slot utilization "
              f"{engine.slot_utilization:.3f})")
        assert len(done) == n_requests
        engines[scheduler] = engine

    wave, cont = engines["wave"], engines["continuous"]
    for uid in sorted(cont.completed):
        r = cont.completed[uid]
        assert r.generated == wave.completed[uid].generated  # golden tokens
        print(f"  req {uid:2d}: prompt len {len(r.prompt):2d} -> "
              f"{len(r.generated):2d} tokens: {r.generated[:8]}"
              f"{'...' if len(r.generated) > 8 else ''}")
    assert cont.steps <= wave.steps
    print(f"continuous spent {wave.steps - cont.steps} fewer fused steps "
          f"than lockstep on the same trace")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
