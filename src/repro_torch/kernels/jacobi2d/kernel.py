"""One Jacobi 2D sweep: the wrapper of the CUDA kernel in
``csrc/jacobi2d.cu``, across from :mod:`repro.kernels.jacobi2d.kernel`.

:func:`jacobi_step` checks ``block_rows`` as the reference does (it must
divide H after clamping to it), then takes CPU tensors to the plain
version in ``ref.py`` and launches the kernel for CUDA tensors; there is no
fallback from one to the other.  ``block_rows`` is the TPU kernel's tile,
checked only; the CUDA kernel's launch shape is ``tile_h``, the rows of its
32-wide block, one of :data:`TILE_HS` (the default, 8, in
``csrc/jacobi2d.cu``, the others in ``csrc/jacobi2d_variants.cu``), and any
other value raises on every device.  :func:`jacobi_step_plain` runs the
plain version on any device, with the same checks.
``jacobi_step.launches`` counts the calls that launched the kernel, and
``jacobi_step.variant_launches`` the same calls by ``tile_h``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.jacobi2d import ref

#: dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
#: the compiled block heights (rows of a 32-wide block), the default first
TILE_HS = (8, 4, 16, 32)


def _check(u: torch.Tensor, block_rows: int, tile_h: int) -> None:
    if u.dim() != 2:
        raise ValueError(f"u must be (H, W), got {tuple(u.shape)}")
    if u.dtype not in _DTYPE_CODE:
        raise TypeError(f"u must be float32 or bfloat16, got {u.dtype}")
    H = u.shape[0]
    br = min(block_rows, H)
    if br <= 0 or H % br:
        raise ValueError(f"H {H} not divisible by block_rows {br}")
    if not u.is_contiguous():
        raise ValueError("u must be contiguous")
    if tile_h not in TILE_HS:
        raise ValueError(f"jacobi2d has no launch variant tile_h={tile_h}; "
                         f"it has {TILE_HS}")


def jacobi_step(u: torch.Tensor, *, block_rows: int = 128,
                tile_h: int = TILE_HS[0]) -> torch.Tensor:
    """One Jacobi sweep over u (H, W): the ring passes through, interior
    points get the 4-neighbour average."""
    _check(u, block_rows, tile_h)
    if u.device.type == "cpu":
        return ref.jacobi_plain(u)
    build.require_cuda("jacobi2d", (u,))
    out = torch.empty_like(u)
    H, W = u.shape
    args = [u.data_ptr(), out.data_ptr(), H, W, _DTYPE_CODE[u.dtype]]
    if tile_h == TILE_HS[0]:
        library, symbol, types = "jacobi2d", "jacobi2d_launch", _ARGTYPES
    else:
        library, symbol = "jacobi2d_variants", "jacobi2d_variant_launch"
        types = _ARGTYPES + [ctypes.c_int]
        args.append(tile_h)
    err = build.function(library, symbol, types + [ctypes.c_void_p])(
        *args, build.stream_of(u))
    build.raise_on(library, err)
    jacobi_step.launches += 1
    jacobi_step.variant_launches[tile_h] = \
        jacobi_step.variant_launches.get(tile_h, 0) + 1
    return out


jacobi_step.launches = 0
jacobi_step.variant_launches = {}


def jacobi_step_plain(u: torch.Tensor, *, block_rows: int = 128,
                      tile_h: int = TILE_HS[0]) -> torch.Tensor:
    _check(u, block_rows, tile_h)
    return ref.jacobi_plain(u)
