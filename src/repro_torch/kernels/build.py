"""Build and load the port's CUDA kernel libraries.

Each CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into the ``build/``
directory of its kernel package, and loaded with ``ctypes``.  Nothing is
built when a module is imported, so the CPU tests import every kernel
module on machines without ``nvcc``.

Every library exports ``<symbol>_launch`` functions that return a CUDA
error code (0 for success) and one ``const char *<error_string>(int)``
that names a code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
    "stream": (KERNELS / "stream/csrc/stream.cu", "stream_error_string"),
    "jacobi2d": (KERNELS / "jacobi2d/csrc/jacobi2d.cu",
                 "jacobi2d_error_string"),
    "spmv": (KERNELS / "spmv/csrc/spmv.cu", "spmv_error_string"),
    "gemm": (KERNELS / "gemm/csrc/gemm.cu", "gemm_error_string"),
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
    """Hash of every source, the shared headers and the flags: editing any
    of them rebuilds every library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(LIBRARIES):
        h.update(LIBRARIES[name][0].read_bytes())
    for header in sorted(INCLUDE.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build(force: bool = False) -> Dict[str, Tuple[Path, str]]:
    """Compile every kernel library; returns {name: (path, compiler
    output)}, the output empty for a library that was already built.

    One ``nvcc`` per source, all started together.  ``force`` rebuilds
    existing libraries.  Each build goes to a temporary name first, so a
    concurrent loader never sees half a file.
    """
    tag = _tag()
    result: Dict[str, Tuple[Path, str]] = {}
    running = {}
    for name, (source, _) in LIBRARIES.items():
        out_dir = build_dir(name)
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / f"lib{name}_{tag}.so"
        if lib.exists() and not force:
            result[name] = (lib, "")
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", str(INCLUDE), "-o", str(tmp),
             str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit code {proc.returncode}:\n{log}")
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
