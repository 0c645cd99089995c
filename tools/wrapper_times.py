#!/usr/bin/env python3
"""Host and device time of one call of the paged flash-decode and
chunked-prefill wrappers, and of one decode layer's attention kernels, at
the serve phases' shapes, for one checkout.

    python3 tools/wrapper_times.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two checkouts can be compared in one
run on one card: the wrappers' signatures are the same in both.  The
inputs and the timers are ``chip_smoke.py``'s (``paged_inputs``,
``prefill_inputs``, ``device_ms``, ``host_us``): qwen3-1.7b heads, 8
slots, 64 blocks of 16 rows, bf16 q, over bf16 and int8 pools; the
decode with lengths over 1..544, the prefill with chunks of 64 rows
after q_start over 0..448.  A decode layer's attention is what
``models/attention.py`` launches for one decode step of one layer: where
the checkout's ``flash_decode_paged`` takes ``k_new``, the one decode call
that commits each slot's new row; else the commit kernel (with its
``q_len`` of ones made there) and then the decode.  The host's time of
a call is taken over
``--rounds`` rounds of 100 calls each (the card idle at the start of
each), and given as the rounds' minimum and median: the host is shared,
so single rounds vary by tens of percent.  Prints one JSON line a
wrapper call, then the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import inspect
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--label", default="")
    parser.add_argument("--rounds", type=int, default=30)
    args = parser.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("wrapper_times: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_decode import kernel, ref

    resolve_device("cuda")
    build.build()  # reuses this checkout's libraries when they are current
    B, C, bs, nb = 8, 64, 16, 64
    KV, G, D = cs.ARCH_HEADS["qwen3-1.7b"]
    valid = np.random.default_rng(8).integers(1, 512 + 32 + 1, size=B)
    q, kp, vp, bt, vl = cs.paged_inputs(torch, B, KV, G, D, bs, nb,
                                        torch.float32, valid.tolist(), 9)
    q = q.to(torch.bfloat16)
    q_start = np.random.default_rng(6).integers(0, 449, size=B)
    pre = cs.prefill_inputs(torch, B, C, KV, G, D, bs, nb, torch.bfloat16,
                            q_start.tolist(), [C] * B, seed=7)
    pos = vl - 1
    k_new, v_new = cs.new_rows(torch, B, KV, D, torch.bfloat16, seed=8)
    fused = "k_new" in inspect.signature(kernel.flash_decode_paged).parameters

    def layer(kq, vq, ks, vs):
        if fused:
            return kernel.flash_decode_paged(q, kq, vq, bt, vl, ks, vs,
                                             k_new=k_new, v_new=v_new)
        kernel.commit_paged(k_new[:, None], v_new[:, None], kq, vq, bt, pos,
                            torch.ones_like(pos), ks, vs)
        return kernel.flash_decode_paged(q, kq, vq, bt, vl, ks, vs)

    calls = {}
    for pool in (torch.bfloat16, torch.int8):
        kq, vq, ks, vs = cs.as_pools(torch, ref, kp, vp, pool)
        calls[f"decode layer {cs.dtype_name(pool)}"] = (
            lambda kq=kq, vq=vq, ks=ks, vs=vs: layer(kq, vq, ks, vs))
        calls[f"flash_decode_paged {cs.dtype_name(pool)}"] = (
            lambda kq=kq, vq=vq, ks=ks, vs=vs: kernel.flash_decode_paged(
                q, kq, vq, bt, vl, ks, vs))
        pq, pv, ps, pvs = cs.as_pools(torch, ref, pre[3].float(),
                                      pre[4].float(), pool)
        calls[f"flash_prefill_paged {cs.dtype_name(pool)}"] = (
            lambda pq=pq, pv=pv, ps=ps, pvs=pvs: kernel.flash_prefill_paged(
                *pre[:3], pq, pv, *pre[5:], ps, pvs))
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        rounds = sorted(cs.host_us(torch, fn, reps=100, rounds=1)
                        for _ in range(args.rounds))
        cs.emit({"label": args.label, "src": args.src, "call": name,
                 "decode_layer": ("fused" if fused else "commit + decode")
                 if name.startswith("decode layer") else None,
                 "host_us_min": rounds[0],
                 "host_us": rounds[len(rounds) // 2],
                 "ms": cs.device_ms(torch, fn)})
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
