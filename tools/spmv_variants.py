#!/usr/bin/env python3
"""Device time of the SpMV kernel and of its gather probe in variants of
the plan's constants, on chip_smoke.py's problem (2^20 rows of block-ELL
width 128, Zipf row_nnz up to 64, fp32): the measurement that chose the
constants of ``src/repro_torch/kernels/spmv/csrc/spmv.cu``.

    python3 tools/spmv_variants.py [--rounds 2]

A variant is this checkout's ``spmv.cu`` with ``kUnroll`` (rows a lane
carries), ``kPredSpan`` (elements one predicated pass of a row covers)
and ``kMinBlocks`` (blocks an SM for ``__launch_bounds__``) replaced,
built with the port's nvcc flags into ``build/spmv_variants/`` of this
checkout, and called through its C interface with the plan that matches
it (fp32, 16-byte vectors).  Each variant's two kernels are held to their
plain versions (``spmv_close``), then timed with ``device_ms``, in rounds
that alternate the variants' order.  Prints one JSON line a (round,
variant), then ``torch.sparse.mm``'s time on the same matrix in CSR and
the card's name and power limit.  Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: name -> (kUnroll, kPredSpan, kMinBlocks); "plan" is the source's own.
#: A warp's rows (32 / lanes * kUnroll) must fit one row_nnz load, so
#: bf16's 4-lane predicated rows cap kUnroll at 4.
VARIANTS = {"plan": None, "unroll1": (1, 32, 3), "unroll2": (2, 32, 3),
            "span64": (4, 64, 3),
            "blocks_unset": (4, 32, 0), "blocks4": (4, 32, 4),
            "blocks5": (4, 32, 5), "blocks8": (4, 32, 8)}
_CONSTANTS = ("kUnroll", "kPredSpan", "kMinBlocks")


def variant_source(text: str, values) -> str:
    """``text`` with the three constants set to ``values``; a kMinBlocks
    of 0 leaves ``__launch_bounds__`` without a minimum."""
    for name, value in zip(_CONSTANTS, values):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith(f"constexpr int {name} = "))
        text = text.replace(line, f"constexpr int {name} = {max(value, 1)};")
    if values[2] == 0:
        text = text.replace("__launch_bounds__(kThreads, kMinBlocks)",
                            "__launch_bounds__(kThreads)")
    return text


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rounds", type=int, default=2)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("spmv_variants: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels.spmv import kernel as spmv, ref as spmv_ref

    resolve_device("cuda")
    source = build.LIBRARIES["spmv"][0]
    text = source.read_text()
    own = tuple(int(next(ln for ln in text.splitlines()
                         if ln.startswith(f"constexpr int {name} = "))
                    .split("=")[1].strip(" ;")) for name in _CONSTANTS)
    out = ROOT / "build" / "spmv_variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, values in VARIANTS.items():
        values = values or own
        (out / f"{name}.cu").write_text(variant_source(text, values))
        procs[name] = (values, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.INCLUDE),
             "-o", str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (values, proc) in procs.items():
        log, _ = proc.communicate()
        cs.require(proc.returncode == 0, f"nvcc {name}:\n{log}")
        regs = [ln.split(":")[-1].strip() for ln in log.splitlines()
                if "registers" in ln]
        lib = ctypes.CDLL(str(out / f"lib{name}.so"))
        lib.spmv_launch.argtypes = spmv._ARGTYPES
        lib.spmv_gather_probe_launch.argtypes = spmv._PROBE_ARGTYPES
        libs[name] = (values, lib)
        cs.emit({"variant": name, "unroll": values[0], "pred_span": values[1],
                 "min_blocks": values[2], "ptxas": regs})

    gen = torch.Generator(device="cuda").manual_seed(21)
    vals, cols, nnz = spmv_ref.make_problem(
        cs.SPMV_ROWS, cs.SPMV_ROWS, row_block=8, max_nnz=cs.SPMV_MAX_NNZ,
        width_pad=cs.SPMV_WIDTH, generator=gen, device="cuda")
    xs = torch.randn((cs.SPMV_ROWS,), device="cuda", generator=gen)
    width = vals.shape[-1]
    y = torch.empty(cs.SPMV_ROWS, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for rnd in range(args.rounds):
        order = list(libs) if rnd % 2 == 0 else list(reversed(libs))
        for name in order:
            (unroll, span, _), lib = libs[name]
            row = {"round": rnd, "variant": name}
            for predicated, key in ((True, "predicated"), (False, "fixed")):
                lanes = span // 4 if predicated else spmv.FIXED_LANES

                def kern():
                    cs.require(lib.spmv_launch(
                        vals.data_ptr(), cols.data_ptr(), nnz.data_ptr(),
                        xs.data_ptr(), y.data_ptr(), cs.SPMV_ROWS, width, 1,
                        1.0, int(predicated), 0, 4, lanes, unroll,
                        stream) == 0, f"{name} launch")

                def probe():
                    cs.require(lib.spmv_gather_probe_launch(
                        nnz.data_ptr(), xs.data_ptr(), y.data_ptr(),
                        cs.SPMV_ROWS, width, cs.SPMV_ROWS, int(predicated),
                        lanes, stream) == 0, f"{name} probe launch")

                kern()
                err, ok = cs.spmv_close(
                    torch, y, spmv_ref.spmv_plain(vals, cols, nnz, xs,
                                                  predicated=predicated),
                    cs.spmv_scale(spmv_ref, vals, cols, nnz, xs,
                                  predicated=predicated))
                cs.require(ok, f"{name} {key} != plain: {err}")
                row[f"{key}_ms"] = cs.device_ms(torch, kern, reps=50)
                row[f"{key}_probe_ms"] = cs.device_ms(torch, probe, reps=50)
            cs.emit(row)
    live = torch.arange(width, device="cuda") < nnz[..., None]
    counts = nnz.reshape(-1).long().clamp(0, width)
    crow = torch.zeros(counts.numel() + 1, dtype=torch.int64, device="cuda")
    crow[1:] = counts.cumsum(0)
    csr = torch.sparse_csr_tensor(crow, cols[live].long(), vals[live],
                                  size=(cs.SPMV_ROWS, cs.SPMV_ROWS))
    cs.emit({"library_ms": cs.device_ms(
        torch, lambda: torch.sparse.mm(csr, xs[:, None]), reps=50)})
    print(cs.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
