"""The RX gate of the state-vector simulator: the wrapper of the CUDA
kernel in ``csrc/rx_gate.cu``, across from
:mod:`repro.kernels.qc_gate.kernel`.

:func:`rx_gate` checks the state's view and ``block_outer`` as the
reference does (``outer * 2 * inner == n_amp``, and ``outer`` divisible by
``min(block_outer, outer)``), then takes CPU tensors to the plain version
in ``ref.py`` and launches the kernel for CUDA tensors; there is no
fallback from one to the other.  ``block_outer`` is the TPU kernel's tile,
checked only; the CUDA kernel's launch shape is ``threads`` a block, one
of :data:`THREADS` (the default, 256, in ``csrc/rx_gate.cu``, the others in
``csrc/rx_gate_variants.cu``), and any other count raises on every device.
:func:`rx_gate_plain` runs the plain version on any device, with the same
checks.  ``rx_gate.launches`` counts the calls that launched the kernel,
and ``rx_gate.variant_launches`` the same calls by ``threads``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.qc_gate import ref

#: dtype codes of the C interface
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_float] * 2 + [ctypes.c_int])
#: the compiled threads a block, the default first
THREADS = (256, 128, 512, 1024)


def _check(re: torch.Tensor, im: torch.Tensor, qubit: int,
           block_outer: int, threads: int) -> None:
    if re.dim() != 1 or im.shape != re.shape:
        raise ValueError(f"re and im must be one (n_amp,) shape, got "
                         f"{tuple(re.shape)} and {tuple(im.shape)}")
    if re.dtype not in _DTYPE_CODE or im.dtype != re.dtype:
        raise TypeError(f"re and im must be float32 or bfloat16, both, got "
                        f"{re.dtype}/{im.dtype}")
    n_amp = re.shape[0]
    if qubit < 0:
        raise ValueError(f"qubit must be >= 0, got {qubit}")
    inner = 1 << qubit
    outer = n_amp // (2 * inner)
    if outer * 2 * inner != n_amp or outer == 0:
        raise ValueError(f"{n_amp} amplitudes have no (outer, 2, {inner}) "
                         f"view for qubit {qubit}")
    bo = min(block_outer, outer)
    if bo <= 0 or outer % bo:
        raise ValueError(f"outer {outer} not divisible by block_outer {bo}")
    if re.device != im.device:
        raise ValueError(f"re and im must lie on one device, got "
                         f"{re.device} and {im.device}")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("re and im must be contiguous")
    if threads not in THREADS:
        raise ValueError(f"the RX gate has no launch variant of {threads} "
                         f"threads; it has {THREADS}")


def rx_gate(re: torch.Tensor, im: torch.Tensor, qubit: int, theta: float, *,
            block_outer: int = 256, threads: int = THREADS[0]):
    """Apply RX(theta) on ``qubit`` to the state (re, im), both (2**n,)
    float32 or bfloat16; returns new (re, im) planes in their dtype."""
    _check(re, im, qubit, block_outer, threads)
    if re.device.type == "cpu":
        return ref.rx_plain(re, im, qubit, theta)
    build.require_cuda("rx_gate", (re, im))
    c, s = ref.rotation(theta, re.dtype)
    ore, oim = torch.empty_like(re), torch.empty_like(im)
    args = [re.data_ptr(), im.data_ptr(), ore.data_ptr(), oim.data_ptr(),
            re.shape[0], qubit, c, s, _DTYPE_CODE[re.dtype]]
    if threads == THREADS[0]:
        library, symbol, types = "rx_gate", "rx_gate_launch", _ARGTYPES
    else:
        library, symbol = "rx_gate_variants", "rx_gate_variant_launch"
        types = _ARGTYPES + [ctypes.c_int]
        args.append(threads)
    err = build.function(library, symbol, types + [ctypes.c_void_p])(
        *args, build.stream_of(re))
    build.raise_on(library, err)
    rx_gate.launches += 1
    rx_gate.variant_launches[threads] = \
        rx_gate.variant_launches.get(threads, 0) + 1
    return ore, oim


rx_gate.launches = 0
rx_gate.variant_launches = {}


def rx_gate_plain(re: torch.Tensor, im: torch.Tensor, qubit: int,
                  theta: float, *, block_outer: int = 256,
                  threads: int = THREADS[0]):
    _check(re, im, qubit, block_outer, threads)
    return ref.rx_plain(re, im, qubit, theta)
