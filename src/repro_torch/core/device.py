"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU.  Asking
for CUDA where there is none raises: nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` ("cuda", "cuda:<i>" or "cpu"),
    checked; plain "cuda" resolves to the current card's index.

    On CUDA, TF32 is switched off for matmuls and cuDNN: the port is held
    against an fp32 reference, and TF32 keeps about three decimal digits.
    """
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if dev.index is None:  # tensors report "cuda:<index>", never "cuda"
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
