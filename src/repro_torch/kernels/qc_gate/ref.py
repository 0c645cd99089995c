"""Oracle, plain version and analytic terms of the RX-gate kernel, across
from :mod:`repro.kernels.qc_gate.ref`.

:func:`rx_ref` is the reference's host oracle (numpy complex128).
:func:`rx_plain` is the kernel's function in plain PyTorch: the TPU
kernel's four real products and sums, with cos and sin of theta / 2
rounded to the planes' dtype first (JAX's weak typing of the Python float
constants) and every product, sum and difference rounded to that dtype, as
arithmetic in that dtype rounds.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def rx_ref(re, im, qubit: int, theta: float):
    """Complex-arithmetic reference on the host (numpy complex128)."""
    psi = _host(re) + 1j * _host(im)
    n_amp = psi.shape[0]
    inner = 1 << qubit
    psi = psi.reshape(n_amp // (2 * inner), 2, inner)
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    a, b = psi[:, 0], psi[:, 1]
    out = np.stack([c * a - 1j * s * b, c * b - 1j * s * a], axis=1)
    out = out.reshape(n_amp)
    return out.real.astype(np.float32), out.imag.astype(np.float32)


def rotation(theta: float, dtype: torch.dtype):
    """(cos(theta / 2), sin(theta / 2)) rounded to ``dtype``, as floats."""
    return tuple(float(torch.tensor(f(theta / 2), dtype=dtype))
                 for f in (math.cos, math.sin))


def rx_plain(re: torch.Tensor, im: torch.Tensor, qubit: int,
             theta: float):
    """RX(theta) on ``qubit`` of the state (re, im), each (2**n,), as the
    kernel computes it: a' = c*a - i s*b and b' = c*b - i s*a on the pairs
    of the (outer, 2, 2**qubit) view, each operation rounded to the planes'
    dtype.  Returns new (re, im) planes."""
    dtype = re.dtype
    c, s = rotation(theta, dtype)
    inner = 1 << qubit
    r = re.float().view(-1, 2, inner)
    i = im.float().view(-1, 2, inner)

    def rnd(x):
        return x.to(dtype).float()

    def mix(x, y, sign):  # round(round(c*x) + sign * round(s*y))
        return (rnd(c * x) + sign * rnd(s * y)).to(dtype)

    ore = torch.stack([mix(r[:, 0], i[:, 1], 1), mix(r[:, 1], i[:, 0], 1)], 1)
    oim = torch.stack([mix(i[:, 0], r[:, 1], -1), mix(i[:, 1], r[:, 0], -1)],
                      1)
    return ore.reshape(re.shape), oim.reshape(im.shape)


def flops_bytes(n_qubits: int, dtype_bytes: int = 4) -> dict:
    """Per gate: 6 real flops per amplitude; read+write both planes."""
    n_amp = float(1 << n_qubits)
    flops = 6.0 * n_amp
    bytes_ = 4.0 * n_amp * dtype_bytes  # re/im read + write
    return {"flops": flops, "bytes": bytes_, "ai": flops / bytes_}


def work_terms(re: torch.Tensor, gates: int = 1) -> dict:
    """What ``gates`` gates on the state must do at least: read both planes
    once and write both once (the gates of a layer chained through the
    cache), and 6 flops per amplitude and gate."""
    n = re.numel()
    return {"flops": 6.0 * n * gates, "bytes": 4.0 * n * re.element_size()}
