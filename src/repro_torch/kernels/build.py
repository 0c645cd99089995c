"""Build and load the port's CUDA kernel libraries.

Each CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into the ``build/``
directory of its kernel package, and loaded with ``ctypes``.  Nothing is
built when a module is imported, so the CPU tests import every kernel
module on machines without ``nvcc``.

Every library exports ``<symbol>_launch`` functions that return a CUDA
error code (0 for success) and one ``const char *<error_string>(int)``
that names a code.  A tunable kernel's source is a header (``*.cuh``)
templated over its launch shape: one library instantiates the default
variant, and a ``*_variants`` library the tuner's others
(:mod:`repro_torch.tuning.spaces`), so the default is built as before and
the variants' ``nvcc`` runs beside it.  A library whose kernels take
long to compile is split into translation units (:data:`PARTS`), each
compiled by an ``nvcc`` of its own beside every other library's, then
linked into the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

KERNELS = Path(__file__).resolve().parent
#: headers shared by the sources (``#include "convert.cuh"``)
INCLUDE = KERNELS / "csrc"
#: library name -> (CUDA source, its error-string function)
LIBRARIES: Dict[str, Tuple[Path, str]] = {
    "flash_decode_paged": (KERNELS / "flash_decode/csrc/flash_decode_paged.cu",
                           "flash_decode_error_string"),
    "flash_prefill_paged": (
        KERNELS / "flash_decode/csrc/flash_prefill_paged.cu",
        "flash_prefill_error_string"),
    "flash_prefill_variants": (
        KERNELS / "flash_decode/csrc/flash_prefill_variants.cu",
        "flash_prefill_error_string"),
    "stream": (KERNELS / "stream/csrc/stream.cu", "stream_error_string"),
    "stream_variants": (KERNELS / "stream/csrc/stream_variants.cu",
                        "stream_error_string"),
    "jacobi2d": (KERNELS / "jacobi2d/csrc/jacobi2d.cu",
                 "jacobi2d_error_string"),
    "jacobi2d_variants": (KERNELS / "jacobi2d/csrc/jacobi2d_variants.cu",
                          "jacobi2d_error_string"),
    "spmv": (KERNELS / "spmv/csrc/spmv.cu", "spmv_error_string"),
    "gemm_wgmma": (KERNELS / "gemm/csrc/gemm_wgmma.cu",
                   "gemm_wgmma_error_string"),
    "gemm_wgmma_variants": (KERNELS / "gemm/csrc/gemm_wgmma_variants.cu",
                            "gemm_wgmma_error_string"),
    "gemm_simt": (KERNELS / "gemm/csrc/gemm_simt.cu",
                  "gemm_simt_error_string"),
    "gemm_simt_variants": (KERNELS / "gemm/csrc/gemm_simt_variants.cu",
                           "gemm_simt_error_string"),
    "rx_gate": (KERNELS / "qc_gate/csrc/rx_gate.cu", "rx_gate_error_string"),
    "rx_gate_variants": (KERNELS / "qc_gate/csrc/rx_gate_variants.cu",
                         "rx_gate_error_string"),
}
#: library name -> the translation units compiled beside its source and
#: linked with it: the decode library's 144 kernels, one dtype pair's (or
#: the contiguous cache's) 24 a unit, which alone took the whole build's
#: wall time as one unit (101 s of a 101 s build on the H100's host)
PARTS: Dict[str, Tuple[Path, ...]] = {
    "flash_decode_paged": tuple(
        KERNELS / f"flash_decode/csrc/flash_decode_{part}.cu"
        for part in ("f32_f32", "f32_bf16", "f32_int8", "bf16_bf16",
                     "bf16_int8", "contiguous")),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: the flags of one translation unit compiled to an object (linked later)
_OBJECT_FLAGS = tuple(f for f in NVCC_FLAGS if f != "-shared") + ("-c",)

#: library name -> wall seconds of its compiles (and link) in the last
#: :func:`build` that built it (all start together, so the largest is the
#: build's)
SECONDS: Dict[str, float] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], object] = {}


def build_dir(name: str) -> Path:
    """``build/`` of the kernel package that holds library ``name``."""
    return LIBRARIES[name][0].parent.parent / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}; the CUDA toolkit is "
            f"needed to build the port's kernels")
    return str(path)


def _tag() -> str:
    """Hash of every source, the shared headers, the packages' own headers
    and the flags: editing any of them rebuilds every library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(LIBRARIES):
        h.update(LIBRARIES[name][0].read_bytes())
        for part in PARTS.get(name, ()):
            h.update(part.read_bytes())
    dirs = {INCLUDE} | {source.parent for source, _ in LIBRARIES.values()}
    for header in sorted(p for d in dirs for p in d.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def _compile(name: str, lib: Path) -> Tuple[int, str]:
    """Compile library ``name`` into ``lib``: one ``nvcc`` for a single
    source; for a library of :data:`PARTS`, one ``nvcc -c`` a translation
    unit, all at once, then one link.  Returns (exit code, output)."""
    sources = (LIBRARIES[name][0],) + PARTS.get(name, ())
    include = ["-I", str(INCLUDE)]
    if len(sources) == 1:
        jobs = [[_nvcc(), *NVCC_FLAGS, *include, "-o", str(lib),
                 str(sources[0])]]
        objects = []
    else:
        objects = [lib.with_name(f"{lib.name}.{i}.o")
                   for i in range(len(sources))]
        jobs = [[_nvcc(), *_OBJECT_FLAGS, *include, "-o", str(obj), str(src)]
                for obj, src in zip(objects, sources)]
    logs = []
    try:
        # outputs to files, not pipes: no compiler waits on a full pipe
        outs = [tempfile.TemporaryFile(mode="w+") for _ in jobs]
        procs = [subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
                 for cmd, out in zip(jobs, outs)]
        codes = [proc.wait() for proc in procs]
        for out in outs:
            out.seek(0)
            logs.append(out.read())
            out.close()
        code = next((c for c in codes if c != 0), 0)
        if code == 0 and objects:
            link = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(lib), *map(str, objects)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            code = link.returncode
            logs.append(link.stdout)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    return code, "".join(logs)


def build(force: bool = False) -> Dict[str, Tuple[Path, str]]:
    """Compile every kernel library; returns {name: (path, compiler
    output)}, the output empty for a library that was already built.

    One ``nvcc`` per source (per translation unit for a library of
    :data:`PARTS`), all started together.  ``force`` rebuilds existing
    libraries.  Each build goes to a temporary name first, so a concurrent
    loader never sees half a file.
    """
    tag = _tag()
    result: Dict[str, Tuple[Path, str]] = {}
    todo = {}
    for name in LIBRARIES:
        out_dir = build_dir(name)
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / f"lib{name}_{tag}.so"
        if lib.exists() and not force:
            result[name] = (lib, "")
            continue
        todo[name] = lib

    def finish(name: str):
        lib = todo[name]
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        code, log = _compile(name, tmp)
        SECONDS[name] = time.perf_counter() - t0
        return name, code, tmp, lib, log

    # a thread a library, so each one's seconds end when it is built
    with ThreadPoolExecutor(max_workers=max(len(todo), 1)) as pool:
        finished = list(pool.map(finish, todo))
    failed = []
    for name, code, tmp, lib, log in finished:
        if code != 0:
            failed.append(f"{name}: nvcc exit code {code}:\n{log}")
            continue
        os.replace(tmp, lib)
        result[name] = (lib, log)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return result


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        path, _ = build()[name]
        lib = ctypes.CDLL(str(path))
        err = getattr(lib, LIBRARIES[name][1])
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def function(name: str, symbol: str, argtypes: Sequence) -> object:
    """The C function ``symbol`` of library ``name`` (built and loaded at
    first use), typed with ``argtypes`` and returning an error code."""
    if (name, symbol) not in _fns:
        fn = getattr(_library(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[name, symbol] = fn
    return _fns[name, symbol]


def raise_on(name: str, err: int) -> None:
    """Raise if a launcher of library ``name`` returned CUDA error
    ``err``."""
    if err != 0:
        msg = getattr(_library(name), LIBRARIES[name][1])(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def require_cuda(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """Raise unless every tensor lies on one CUDA device: the kernel of
    library ``name`` runs only there."""
    devices = {t.device for t in tensors}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"the {name} kernel needs tensors on one CUDA "
                         f"device, got {sorted(map(str, devices))}")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s card."""
    return torch.cuda.current_stream(t.device).cuda_stream
