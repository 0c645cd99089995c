"""Block-ELL SpMV, predicated and fixed-width: the wrappers of the CUDA
kernel in ``csrc/spmv.cu``, across from :mod:`repro.kernels.spmv.kernel`.

Both entry points check their arguments, then take CPU tensors to the plain
version in ``ref.py`` and launch the kernel for CUDA tensors; there is no
fallback from one to the other.  The ``*_plain`` twins run the plain
version on any device, with the same checks.  Each entry point's
``launches`` attribute counts the calls that launched the kernel, and its
``last_plan`` is the plan of the last of them.  :func:`spmv_plan` picks the
kernel's instantiation from the width, the dtype, the variant and the
inputs' alignment alone.  :func:`spmv_gather_probe` runs the kernel's
gathers alone, the floor they set on the card (a measurement, on no entry
point's path).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.spmv import ref

#: dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the plan's constants, as ``csrc/spmv.cu`` defines them: elements one
#: pass of a predicated row covers, lanes a fixed-width row at most, rows
#: a lane carries (vector and scalar instantiations)
PRED_SPAN = 32
FIXED_LANES = 32
UNROLL = 4
UNROLL_SCALAR = 4
_ARGTYPES = ([ctypes.c_void_p] * 5
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
_PROBE_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])


class SpmvPlan(NamedTuple):
    """How the kernel reads a matrix: ``lanes`` lanes a row, ``rows`` rows
    a warp at once (32 / lanes), ``vec`` elements a lane loads at once,
    and ``unroll`` rows a lane carries, so that a warp takes ``rows *
    unroll`` neighbouring rows."""

    lanes: int
    rows: int
    vec: int
    unroll: int


@functools.lru_cache(maxsize=64)
def spmv_plan(width: int, dtype: torch.dtype, predicated: bool,
              aligned: bool = True) -> SpmvPlan:
    """The instantiation of ``csrc/spmv.cu`` for rows of ``width`` in
    ``dtype``; ``aligned``: values and col_idx start on 16-byte
    boundaries.

    A lane loads 16 bytes of values (4 fp32 or 8 bf16) and their column
    indices when ``aligned`` and ``width`` is a multiple of that vector, so
    that every row starts on a vector; else one element (the scalar route,
    32 lanes a row, :data:`UNROLL_SCALAR` rows a lane).  Predicated, a
    row's lanes cover :data:`PRED_SPAN` elements a pass (8 fp32 lanes, 4
    bf16), above the mean ``row_nnz`` of the paper's problem, so that most
    rows take one pass and a warp holds 4 (fp32) or 8 (bf16) rows.  Fixed
    width, the largest power of two of lanes, from 8 to
    :data:`FIXED_LANES`, that the row's vectors fill: one pass of a
    128-wide row in either dtype."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"spmv takes float32 or bfloat16, got {dtype}")
    if width < 1:
        raise ValueError(f"spmv needs a width of at least 1, got {width}")
    per = 16 // dtype.itemsize
    if not aligned or width % per:
        return SpmvPlan(32, 1, 1, UNROLL_SCALAR)
    if predicated:
        lanes = PRED_SPAN // per
    else:
        lanes = FIXED_LANES
        while lanes > 8 and lanes * per > width:
            lanes //= 2
    return SpmvPlan(lanes, 32 // lanes, per, UNROLL)


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
    if y.numel() == 0:
        return y
    plan = spmv_plan(width, values.dtype, predicated,
                     (values.data_ptr() | col_idx.data_ptr()) % 16 == 0)
    err = build.function("spmv", "spmv_launch", _ARGTYPES)(
        values.data_ptr(), col_idx.data_ptr(), row_nnz.data_ptr(),
        x.data_ptr(), y.data_ptr(), nb * rb, width, repeat, inv,
        int(predicated), _DTYPE_CODE[values.dtype], plan.vec, plan.lanes,
        plan.unroll, build.stream_of(values))
    build.raise_on("spmv", err)
    entry.launches += 1
    entry.last_plan = plan
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


for _entry in (spmv_blockell, spmv_fixed_width):
    _entry.launches = 0
    _entry.last_plan = None


def _check_probe(row_nnz, x, width: int) -> None:
    if row_nnz.dim() != 2 or row_nnz.dtype != torch.int32:
        raise ValueError(f"row_nnz must be (nb, rb) int32, got "
                         f"{tuple(row_nnz.shape)} {row_nnz.dtype}")
    if x.dim() != 1 or x.dtype != torch.float32:
        raise ValueError(f"x must be (n_cols,) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if width < 4 or width % 4:
        raise ValueError(f"the probe takes widths of whole fp32 vectors, "
                         f"got {width}")
    if row_nnz.device != x.device or not (row_nnz.is_contiguous()
                                          and x.is_contiguous()):
        raise ValueError("probe inputs must be contiguous on one device")


def spmv_gather_probe(row_nnz: torch.Tensor, x: torch.Tensor, width: int, *,
                      predicated: bool = True) -> torch.Tensor:
    """The fp32 kernel's gathers alone: ``y[r]`` = the sum of
    ``x[ref.probe_columns(...)]`` over row r's live lanes (its first
    ``row_nnz[r]``, clamped to [0, width], or all ``width`` of them), in
    the layout of ``spmv_plan(width, float32, predicated)``, with no values
    or column indices read.  Its time on the card is the floor that the
    gathers of x set on the SpMV kernel.  CPU tensors take the plain
    version.  Returns (nb*rb,) float32."""
    _check_probe(row_nnz, x, width)
    if row_nnz.device.type == "cpu":
        return ref.gather_probe_plain(row_nnz, x, width,
                                      predicated=predicated)
    build.require_cuda("spmv", (row_nnz, x))
    y = torch.empty(row_nnz.numel(), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    plan = spmv_plan(width, torch.float32, predicated)
    err = build.function("spmv", "spmv_gather_probe_launch", _PROBE_ARGTYPES)(
        row_nnz.data_ptr(), x.data_ptr(), y.data_ptr(), y.numel(), width,
        x.numel(), int(predicated), plan.lanes, build.stream_of(x))
    build.raise_on("spmv", err)
    spmv_gather_probe.launches += 1
    return y


spmv_gather_probe.launches = 0
