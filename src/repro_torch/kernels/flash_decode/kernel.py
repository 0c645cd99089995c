"""Paged flash-decode: the wrapper of ``csrc/flash_decode_paged.cu``.

The CUDA source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into ``build/`` beside this
file, and loaded with ``ctypes``.  Nothing is built when the module is
imported, so the CPU tests import it on machines without ``nvcc``.

:func:`flash_decode_paged` takes CPU tensors to the plain version in
``ref.py`` and launches the kernel for CUDA tensors; there is no fallback
from one to the other.  ``flash_decode_paged.launches`` counts the kernel
launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_decode import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode_paged.cu"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
HEAD_DIMS = (64, 128)
#: dynamic shared memory a block may use without an opt-in attribute
_SMEM_LIMIT = 48 * 1024

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}; the CUDA toolkit is "
            f"needed to build the paged flash-decode kernel")
    return str(path)


def build(force: bool = False) -> Tuple[Path, str]:
    """Compile the kernel library; returns (path, compiler output).

    The library's name carries a hash of the source and flags, so an edited
    source is rebuilt; ``force`` rebuilds an existing one.  The build goes
    to a temporary name first, so a concurrent loader never sees half a
    file.
    """
    tag = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    lib = BUILD_DIR / f"libflash_decode_{tag}.so"
    if lib.exists() and not force:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        fn = lib.flash_decode_paged_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(q, k_pool, v_pool, block_tables, valid_len) -> None:
    if q.dim() != 4:
        raise ValueError(f"q must be (B, KV, G, D), got {tuple(q.shape)}")
    B, KV, G, D = q.shape
    if k_pool.dim() != 4 or k_pool.shape[2:] != (KV, D):
        raise ValueError(f"k_pool must be (n_blocks, bs, {KV}, {D}), got "
                         f"{tuple(k_pool.shape)}")
    if v_pool.shape != k_pool.shape:
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != k_pool "
                         f"{tuple(k_pool.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be ({B}, nb), got "
                         f"{tuple(block_tables.shape)}")
    if tuple(valid_len.shape) != (B,):
        raise ValueError(f"valid_len must be ({B},), got "
                         f"{tuple(valid_len.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"pools must have q's dtype {q.dtype}, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    if block_tables.dtype != torch.int32 or valid_len.dtype != torch.int32:
        raise TypeError("block_tables and valid_len must be int32")
    tensors = (q, k_pool, v_pool, block_tables, valid_len)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must lie on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("all inputs must be contiguous")


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       valid_len: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention over a paged KV cache.

    q (B, KV, G, D); k/v_pool (n_blocks, bs, KV, D) in q's dtype;
    block_tables (B, nb) int32; valid_len (B,) int32, every entry >= 1 and
    every table entry a block of the pool (not checked: both live on the
    device).  Returns (B, KV, G, D) in q's dtype.
    """
    _check(q, k_pool, v_pool, block_tables, valid_len)
    if q.device.type == "cpu":
        return ref.flash_decode_paged_ref(q, k_pool, v_pool, block_tables,
                                          valid_len)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, KV, G, D = q.shape
    bs = k_pool.shape[1]
    nb = block_tables.shape[1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    smem = 4 * (2 * G * D + G * bs + 3 * G) + 4 * nb
    if smem > _SMEM_LIMIT:
        raise ValueError(f"G={G}, D={D}, bs={bs}, nb={nb} need {smem} bytes "
                         f"of shared memory, over {_SMEM_LIMIT}")
    out = torch.empty_like(q)
    lib = _library()
    err = lib.flash_decode_paged_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), valid_len.data_ptr(), out.data_ptr(),
        B, KV, G, D, bs, nb, _DTYPE_CODE[q.dtype], q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash_decode_paged launch failed: CUDA error {err} "
            f"({lib.flash_decode_error_string(err).decode()})")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0
