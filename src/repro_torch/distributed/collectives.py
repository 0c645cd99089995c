"""The collectives of tensor-parallel serving, with their own counters.

A :class:`Collectives` object runs the three collectives the mesh path
needs over a ``torch.distributed`` group: all-gather on an axis, all-reduce
SUM and all-reduce MAX.  It counts calls, the bytes each rank puts in, and
the bytes staged through the host.

Staging is part of the design.  On one card the ranks share the device,
which NCCL refuses, so they talk over gloo; gloo has no CUDA all-gather,
and its CUDA all-reduce copies to the host itself.  So under gloo a CUDA
tensor is copied to a host tensor, the collective runs there, and the
result is copied back.  Every kernel and matmul still runs on the card.
With NCCL (every rank on a card of its own) nothing is staged.

Both all-reduces leave the same bits on every rank of the group: each
element is reduced once and the result copied to the others.
"""

from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist


class Collectives:
    """Collectives over process groups of one backend, counted."""

    def __init__(self, backend: str):
        self.backend = backend
        #: collectives run (one a call that crossed ranks)
        self.calls = 0
        #: bytes this rank put into them
        self.bytes = 0
        #: bytes copied between the card and the host for gloo: out and back
        self.host_bytes = 0

    def counters(self) -> dict:
        return {"calls": self.calls, "bytes": self.bytes,
                "host_bytes": self.host_bytes}

    def _count(self, x: torch.Tensor, copies: int) -> bool:
        """Count one collective of ``x``, and ``copies`` times its bytes
        staged when it is; returns whether it is staged."""
        self.calls += 1
        self.bytes += x.numel() * x.element_size()
        staged = self.backend == "gloo" and x.device.type == "cuda"
        if staged:
            self.host_bytes += copies * x.numel() * x.element_size()
        return staged

    def all_gather(self, x: torch.Tensor, group, n: int,
                   dim: int = 0) -> torch.Tensor:
        """The ``n`` ranks' ``x`` concatenated on ``dim`` in rank order;
        ``x`` itself when ``n`` is 1."""
        if n == 1:
            return x
        src = x.contiguous()
        if self._count(src, 1 + n):  # out, and every part back
            src = src.cpu()
        parts: List[torch.Tensor] = [torch.empty_like(src)
                                     for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    def _all_reduce(self, x: torch.Tensor, group, n: int, op
                    ) -> torch.Tensor:
        if n == 1:
            return x
        out = x.cpu() if self._count(x, 2) else x.clone()
        dist.all_reduce(out, op=op, group=group)
        return out.to(x.device)

    def all_reduce_sum(self, x: torch.Tensor, group, n: int
                       ) -> torch.Tensor:
        """The sum of the ``n`` ranks' ``x``."""
        return self._all_reduce(x, group, n, dist.ReduceOp.SUM)

    def all_reduce_max(self, x: torch.Tensor, group, n: int
                       ) -> torch.Tensor:
        """The elementwise max of the ``n`` ranks' ``x``."""
        return self._all_reduce(x, group, n, dist.ReduceOp.MAX)
