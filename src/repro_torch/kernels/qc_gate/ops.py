"""RX-gate kernel call surface (served by the kernel registry) + circuit
drivers, across from :mod:`repro.kernels.qc_gate.ops`."""

from __future__ import annotations

import torch

from repro_torch.kernels.registry import RX_GATE as rx_gate

__all__ = ["rx_gate", "rx_layer", "zero_state"]


def rx_layer(re, im, n_qubits: int, theta: float):
    """The paper's benchmark: one RX on every qubit (21-qubit problem), one
    kernel launch a gate on the card."""
    for q in range(n_qubits):
        re, im = rx_gate(re, im, qubit=q, theta=theta)
    return re, im


def zero_state(n_qubits: int, device="cuda"):
    """|0...0> as float32 (re, im) planes of 2**n_qubits amplitudes, on
    ``device`` (the card unless the caller asks for the CPU)."""
    n_amp = 1 << n_qubits
    re = torch.zeros((n_amp,), dtype=torch.float32, device=device)
    re[0] = 1.0
    im = torch.zeros((n_amp,), dtype=torch.float32, device=device)
    return re, im
