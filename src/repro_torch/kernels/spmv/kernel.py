"""Block-ELL SpMV, predicated and fixed-width: the wrappers of the CUDA
kernel in ``csrc/spmv.cu``, across from :mod:`repro.kernels.spmv.kernel`.

Both entry points check their arguments, then take CPU tensors to the
plain version in ``ref.py`` and launch the kernel for CUDA tensors; there is
no fallback from one to the other.  The ``*_plain`` twins run the plain
version on any device, with the same checks.  Each entry point's
``launches`` attribute counts the calls that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.spmv import ref

#: dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _check(values, col_idx, row_nnz, x) -> None:
    if values.dim() != 3:
        raise ValueError(f"values must be (nb, rb, width), got "
                         f"{tuple(values.shape)}")
    nb, rb, _ = values.shape
    if col_idx.shape != values.shape:
        raise ValueError(f"col_idx {tuple(col_idx.shape)} != values "
                         f"{tuple(values.shape)}")
    if tuple(row_nnz.shape) != (nb, rb):
        raise ValueError(f"row_nnz must be ({nb}, {rb}), got "
                         f"{tuple(row_nnz.shape)}")
    if x.dim() != 1:
        raise ValueError(f"x must be (n_cols,), got {tuple(x.shape)}")
    if values.dtype not in _DTYPE_CODE or x.dtype != values.dtype:
        raise TypeError(f"values and x must be one of float32/bfloat16, got "
                        f"{values.dtype} and {x.dtype}")
    if col_idx.dtype != torch.int32 or row_nnz.dtype != torch.int32:
        raise TypeError(f"col_idx and row_nnz must be int32, got "
                        f"{col_idx.dtype} and {row_nnz.dtype}")
    tensors = (values, col_idx, row_nnz, x)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("SpMV inputs must lie on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("SpMV inputs must be contiguous")


def _run(entry, values, col_idx, row_nnz, x, repeat: int, predicated: bool,
         plain: bool) -> torch.Tensor:
    _check(values, col_idx, row_nnz, x)
    inv = torch.tensor(1.0 / repeat, dtype=values.dtype).item()
    if plain or values.device.type == "cpu":
        return ref.spmv_plain(values, col_idx, row_nnz, x, repeat=repeat,
                              predicated=predicated)
    build.require_cuda("spmv", (values, col_idx, row_nnz, x))
    nb, rb, width = values.shape
    y = torch.empty(nb * rb, dtype=values.dtype, device=values.device)
    err = build.function("spmv", "spmv_launch", _ARGTYPES)(
        values.data_ptr(), col_idx.data_ptr(), row_nnz.data_ptr(),
        x.data_ptr(), y.data_ptr(), nb * rb, width, repeat, inv,
        int(predicated), _DTYPE_CODE[values.dtype], build.stream_of(values))
    build.raise_on("spmv", err)
    entry.launches += 1
    return y


def spmv_blockell(values, col_idx, row_nnz, x, *, repeat: int = 1):
    """y = A @ x for block-ELL A, lanes past each row's ``row_nnz``
    predicated off.  values/col_idx (nb, rb, width), row_nnz (nb, rb),
    x (n_cols,); every column index a row reads must be a column of x (not
    checked: it lives on the device).  Returns (nb*rb,)."""
    return _run(spmv_blockell, values, col_idx, row_nnz, x, repeat, True,
                False)


def spmv_fixed_width(values, col_idx, row_nnz, x):
    """The fixed-width strawman: no predicate, every lane of the padded
    width is loaded and multiplied (padding values are zero, so the result
    equals :func:`spmv_blockell`'s)."""
    return _run(spmv_fixed_width, values, col_idx, row_nnz, x, 1, False,
                False)


def spmv_blockell_plain(values, col_idx, row_nnz, x, *, repeat: int = 1):
    return _run(None, values, col_idx, row_nnz, x, repeat, True, True)


def spmv_fixed_width_plain(values, col_idx, row_nnz, x):
    return _run(None, values, col_idx, row_nnz, x, 1, False, True)


spmv_blockell.launches = 0
spmv_fixed_width.launches = 0
