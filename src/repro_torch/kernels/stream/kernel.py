"""STREAM copy / scale / add / triad: the wrappers of the CUDA kernel in
``csrc/stream.cu``, across from :mod:`repro.kernels.stream.kernel`.

Each entry point checks its arguments as the reference does (``block_rows``
must divide the rows, after clamping to them), then takes CPU tensors to
the plain version in ``ref.py`` and launches the kernel for CUDA tensors;
there is no fallback from one to the other.  ``block_rows`` is the TPU
kernel's tile; the CUDA kernel picks its own launch shape.  The ``*_plain``
twins run the plain version on any device, with the same checks.  Each
entry point's ``launches`` attribute counts the calls that launched the
kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.stream import ref

_OPS = {"copy": 0, "scale": 1, "add": 2, "triad": 3}
#: dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]


def _check(arrays, block_rows: int) -> None:
    a = arrays[0]
    if a.dim() != 2:
        raise ValueError(f"STREAM arrays must be (rows, width), got "
                         f"{tuple(a.shape)}")
    if a.dtype not in _DTYPE_CODE:
        raise TypeError(f"STREAM arrays must be float32, bfloat16 or "
                        f"float16, got {a.dtype}")
    for t in arrays[1:]:
        if t.shape != a.shape or t.dtype != a.dtype:
            raise ValueError(f"STREAM arrays differ: {tuple(a.shape)} "
                             f"{a.dtype} and {tuple(t.shape)} {t.dtype}")
    rows = a.shape[0]
    br = min(block_rows, rows)
    if br <= 0 or rows % br:
        raise ValueError(f"rows {rows} not divisible by block_rows {br}")
    if len({t.device for t in arrays}) != 1:
        raise ValueError("STREAM arrays must lie on one device")
    if not all(t.is_contiguous() for t in arrays):
        raise ValueError("STREAM arrays must be contiguous")


def _run(entry, op: str, arrays, q: float, block_rows: int,
         plain: bool) -> torch.Tensor:
    _check(arrays, block_rows)
    a = arrays[0]
    q = ref.round_to(q, a.dtype)
    if plain or a.device.type == "cpu":
        return ref.stream_plain(op, *arrays, q=q)
    build.require_cuda("stream", arrays)
    c = torch.empty_like(a)
    b = arrays[1] if len(arrays) > 1 else None
    err = build.function("stream", "stream_launch", _ARGTYPES)(
        a.data_ptr(), None if b is None else b.data_ptr(), c.data_ptr(),
        a.numel(), _OPS[op], q, _DTYPE_CODE[a.dtype], build.stream_of(a))
    build.raise_on("stream", err)
    entry.launches += 1
    return c


def stream_copy(a, *, block_rows: int = 256):
    """c = a."""
    return _run(stream_copy, "copy", (a,), 0.0, block_rows, False)


def stream_scale(a, q: float, *, block_rows: int = 256):
    """c = q * a."""
    return _run(stream_scale, "scale", (a,), q, block_rows, False)


def stream_add(a, b, *, block_rows: int = 256):
    """c = a + b."""
    return _run(stream_add, "add", (a, b), 0.0, block_rows, False)


def stream_triad(a, b, q: float, *, block_rows: int = 256):
    """c = a + q * b."""
    return _run(stream_triad, "triad", (a, b), q, block_rows, False)


def stream_copy_plain(a, *, block_rows: int = 256):
    return _run(None, "copy", (a,), 0.0, block_rows, True)


def stream_scale_plain(a, q: float, *, block_rows: int = 256):
    return _run(None, "scale", (a,), q, block_rows, True)


def stream_add_plain(a, b, *, block_rows: int = 256):
    return _run(None, "add", (a, b), 0.0, block_rows, True)


def stream_triad_plain(a, b, q: float, *, block_rows: int = 256):
    return _run(None, "triad", (a, b), q, block_rows, True)


for _entry in (stream_copy, stream_scale, stream_add, stream_triad):
    _entry.launches = 0
