#!/usr/bin/env python3
"""Device time of the GEMM (8192^3 in fp32 and bf16), of the four STREAM
ops (2^21 x 128 fp32) and of the two SpMV kernels (2^20 rows of block-ELL
width 128, Zipf row_nnz up to 64, fp32) for one checkout, beside their
plain versions, their bounds and one PyTorch call computing the same
function (for SpMV ``torch.sparse.mm`` on the same matrix in CSR).

    python3 tools/kernel_times.py [--src DIR] [--label NAME]
                                  [--kernels gemm,stream,spmv]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (by
default this checkout's), so that two checkouts can be compared in one
run on one card: the wrappers' signatures are the same in both.  The
shapes, timers, bounds and tolerances are ``chip_smoke.py``'s (this
checkout's): each kernel is first held against its plain version (GEMM
within ``gemm_close``, STREAM within ``exact_close``, SpMV within
``spmv_close``), then timed as the median of CUDA-event timings.  A GEMM
row names the route that ran where the checkout counts launches by route;
an SpMV row the plan that ran and, where the checkout has the gather
probe, the probe's time: the same gathers of x with no values or column
indices read, the floor the L2 gathers set.  Prints one JSON line a
kernel, then the card's name and power limit.  Needs one CUDA card.
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
    parser.add_argument("--kernels", default="gemm,stream,spmv",
                        help="comma-separated subset of gemm,stream,spmv")
    args = parser.parse_args()
    kernels = set(args.kernels.split(","))
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

    if "spmv" in kernels:
        spmv_times(torch, cs, emit)
    if "gemm" in kernels:
        gemm_times(torch, cs, gemm, gemm_ref, gen, emit)
    if "stream" in kernels:
        stream_times(torch, cs, stream, stream_ref, gen, emit)
    print(card, flush=True)
    return 0


def gemm_times(torch, cs, gemm, gemm_ref, gen, emit):
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


def stream_times(torch, cs, stream, stream_ref, gen, emit):
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


def spmv_times(torch, cs, emit):
    """Both SpMV kernels on chip_smoke's problem (its seed, 2^20 rows),
    with ``torch.sparse.mm`` on the same matrix in CSR and the gather
    probe where the checkout has it."""
    from repro_torch.kernels.spmv import kernel as spmv, ref as spmv_ref

    gen = torch.Generator(device="cuda").manual_seed(21)
    vals, cols, nnz = spmv_ref.make_problem(
        cs.SPMV_ROWS, cs.SPMV_ROWS, row_block=8, max_nnz=cs.SPMV_MAX_NNZ,
        width_pad=cs.SPMV_WIDTH, generator=gen, device="cuda")
    xs = torch.randn((cs.SPMV_ROWS,), device="cuda", generator=gen)
    width = vals.shape[-1]
    live = torch.arange(width, device="cuda") < nnz[..., None]
    counts = nnz.reshape(-1).long().clamp(0, width)
    crow = torch.zeros(counts.numel() + 1, dtype=torch.int64, device="cuda")
    crow[1:] = counts.cumsum(0)
    csr = torch.sparse_csr_tensor(crow, cols[live].long(), vals[live],
                                  size=(cs.SPMV_ROWS, cs.SPMV_ROWS))
    xcol = xs[:, None]
    probe = getattr(spmv, "spmv_gather_probe", None)
    for name, kern, plain, predicated in (
            ("spmv_blockell", spmv.spmv_blockell, spmv.spmv_blockell_plain,
             True),
            ("spmv_fixed_width", spmv.spmv_fixed_width,
             spmv.spmv_fixed_width_plain, False)):
        want = plain(vals, cols, nnz, xs)
        scale = cs.spmv_scale(spmv_ref, vals, cols, nnz, xs,
                              predicated=predicated)
        err, ok = cs.spmv_close(torch, kern(vals, cols, nnz, xs), want,
                                scale)
        cs.require(ok, f"{name} kernel != plain: {err}")
        lib_err, lib_ok = cs.spmv_close(
            torch, torch.sparse.mm(csr, xcol)[:, 0], want, scale)
        cs.require(lib_ok, f"spmv library yardstick disagrees: {lib_err}")
        bound_ms, bound_by = cs.bound(
            spmv_ref.work_terms(vals, nnz, xs, predicated=predicated),
            "float32")
        plan = getattr(kern, "last_plan", None)
        floor = None if probe is None else cs.device_ms(
            torch, lambda: probe(nnz, xs, width, predicated=predicated),
            reps=50)
        emit(name, dtype="float32", rows=cs.SPMV_ROWS, width=width,
             nnz=int(counts.sum()),
             gathers=int(counts.sum()) if predicated else vals.numel(),
             plan=None if plan is None else plan._asdict(),
             max_abs_err=err,
             ms=cs.device_ms(torch, lambda: kern(vals, cols, nnz, xs),
                             reps=50),
             plain_ms=cs.device_ms(torch, lambda: plain(vals, cols, nnz, xs),
                                   reps=30),
             bound_ms=bound_ms, bound_by=bound_by, gather_floor_ms=floor,
             library_ms=cs.device_ms(torch,
                                     lambda: torch.sparse.mm(csr, xcol),
                                     reps=50))


if __name__ == "__main__":
    raise SystemExit(main())
