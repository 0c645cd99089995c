#!/usr/bin/env python3
"""Device time of the GEMM (8192^3 in fp32 and bf16) and of the four STREAM
ops (2^21 x 128 fp32) for one checkout, beside their plain versions, their
bounds and one PyTorch call computing the same function.

    python3 tools/kernel_times.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two checkouts can be compared in one
run on one card: the wrappers' signatures are the same in both.  The
shapes, timers, bounds and tolerances are ``chip_smoke.py``'s (this
checkout's): each kernel is first held against its plain version (GEMM
within ``gemm_close``, STREAM within ``exact_close``), then timed as the
median of CUDA-event timings.  A GEMM row names the route that ran where
the checkout counts launches by route.  Prints one JSON line a kernel,
then the card's name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--src", default=str(ROOT / "src"))
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.gemm import kernel as gemm, ref as gemm_ref
    from repro_torch.kernels.stream import kernel as stream, ref as stream_ref

    resolve_device("cuda")  # also switches TF32 off
    build.build()  # reuses this checkout's libraries when they are current
    gen = torch.Generator(device="cuda").manual_seed(21)
    card = cs.nvidia_smi()

    def emit(kernel, **row):
        cs.emit({"label": args.label, "src": args.src, "kernel": kernel,
                 **row, "card": card})

    x, y = (torch.randn((cs.GEMM_N, cs.GEMM_N), device="cuda",
                        generator=gen) for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        xd, yd = x.to(dtype), y.to(dtype)
        routes = dict(getattr(gemm.gemm, "route_launches", {}))
        err, ok = cs.gemm_close(torch, gemm.gemm(xd, yd),
                                gemm.gemm_plain(xd, yd))
        cs.require(ok, f"gemm {dtype} kernel != plain: {err}")
        ran = [r for r, n in getattr(gemm.gemm, "route_launches", {}).items()
               if n != routes[r]]
        name = cs.dtype_name(dtype)
        bound_ms, bound_by = cs.bound(gemm_ref.work_terms(xd, yd), name)
        reps = 5 if dtype == torch.float32 else 20
        emit("gemm", dtype=name, shape=[cs.GEMM_N] * 3,
             route=ran[0] if len(ran) == 1 else None, max_abs_err=err,
             ms=cs.device_ms(torch, lambda: gemm.gemm(xd, yd), reps=reps,
                             warmup=2),
             plain_ms=cs.device_ms(torch, lambda: gemm.gemm_plain(xd, yd),
                                   reps=5, warmup=2),
             bound_ms=bound_ms, bound_by=bound_by,
             library_ms=cs.device_ms(torch, lambda: torch.matmul(xd, yd),
                                     reps=reps, warmup=2))
        del xd, yd
    del x, y

    a, b = (torch.randn(cs.STREAM_SHAPE, device="cuda", generator=gen)
            for _ in range(2))
    c = torch.empty_like(a)
    q = cs.STREAM_Q
    library = {"copy": lambda: c.copy_(a),
               "scale": lambda: torch.mul(a, q, out=c),
               "add": lambda: torch.add(a, b, out=c),
               "triad": lambda: torch.add(a, b, alpha=q, out=c)}
    for op in cs.STREAM_OPS:
        op_args = {"copy": (a,), "scale": (a, q), "add": (a, b),
                   "triad": (a, b, q)}[op]
        kern = getattr(stream, f"stream_{op}")
        plain = getattr(stream, f"stream_{op}_plain")
        err, ok, bit = cs.exact_close(torch, kern(*op_args), plain(*op_args))
        cs.require(ok, f"stream {op} kernel != plain: {err}")
        bound_ms, bound_by = cs.bound(stream_ref.work_terms(op, a), "float32")
        emit(f"stream_{op}", dtype="float32", shape=list(cs.STREAM_SHAPE),
             max_abs_err=err, bit_equal=bit,
             ms=cs.device_ms(torch, lambda: kern(*op_args), reps=30),
             plain_ms=cs.device_ms(torch, lambda: plain(*op_args), reps=30),
             bound_ms=bound_ms, bound_by=bound_by,
             library_ms=cs.device_ms(torch, library[op], reps=30))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
