"""The collectives of the mesh paths, with their own counters.

A :class:`Collectives` object runs the collectives the serve and train
meshes need over a ``torch.distributed`` group: all-gather on an axis,
all-reduce SUM and all-reduce MAX, and for the train step's data axis a
reduce-scatter and an all-gather of flat buffers.  It counts calls, the
bytes each rank puts in, and the bytes staged through the host.

Staging is part of the design.  On one card the ranks share the device,
which NCCL refuses, so they talk over gloo; gloo has no CUDA all-gather,
and its CUDA all-reduce copies to the host itself.  So under gloo a CUDA
tensor is copied to a host tensor, the collective runs there, and the
result is copied back.  Every kernel and matmul still runs on the card.
With NCCL (every rank on a card of its own) nothing is staged.

Both all-reduces leave the same bits on every rank of the group: each
element is reduced once and the result copied to the others.  The
reduce-scatter is the all-reduce SUM followed by a slice, so that a ZeRO
step's gradient shard holds the bits of the same slice of the replicated
step's summed gradient, and both steps leave the same bits on every rank.

The train step's flat buffers (its gradients and its ZeRO parameters,
gigabytes a step) do not go through the host where the ranks share one
card: gloo moves them at about 1 GB/s.  Each rank builds such a buffer in
a persistent one of its own (:meth:`Collectives.shared_flat`), whose CUDA
IPC handle every rank of the group opened once, and after a barrier every
rank reads the others' on the card: the sum adds the ranks' buffers in
rank order (so every rank, and a slice of the sum, holds the same bits),
the gather concatenates them, and a second barrier lets the owners write
again.  These count as the other collectives do, with no host bytes.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist


class Collectives:
    """Collectives over process groups of one backend, counted.
    ``shared_card``: every rank runs on one card (gloo over CUDA), where
    the flat collectives read each other's buffers through CUDA IPC."""

    def __init__(self, backend: str, shared_card: bool = False):
        self.backend = backend
        self.shared_card = shared_card
        #: (key, group) -> (this rank's buffer, every rank's, in order)
        self._shared: Dict[Tuple, Tuple[torch.Tensor, List]] = {}
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

    def _all_reduce(self, x: torch.Tensor, group, n: int, op,
                    inplace: bool = False) -> torch.Tensor:
        if n == 1:
            return x
        staged = self._count(x, 2)
        out = x.cpu() if staged else (x if inplace else x.clone())
        dist.all_reduce(out, op=op, group=group)
        if not staged:
            return out
        return x.copy_(out) if inplace else out.to(x.device)

    def all_reduce_sum(self, x: torch.Tensor, group, n: int, *,
                       inplace: bool = False) -> torch.Tensor:
        """The sum of the ``n`` ranks' ``x``; with ``inplace`` written
        into ``x`` (no second buffer on the card)."""
        return self._all_reduce(x, group, n, dist.ReduceOp.SUM, inplace)

    def all_reduce_max(self, x: torch.Tensor, group, n: int
                       ) -> torch.Tensor:
        """The elementwise max of the ``n`` ranks' ``x``."""
        return self._all_reduce(x, group, n, dist.ReduceOp.MAX)

    # -- flat buffers of the train step ------------------------------------

    def _ipc(self, flat: torch.Tensor, n: int) -> bool:
        return self.shared_card and n > 1 and flat.device.type == "cuda"

    def shared_flat(self, key, numel: int, dtype, device, group, n: int
                    ) -> torch.Tensor:
        """A 1-D buffer of ``numel`` ``dtype`` elements to build a flat
        collective's input in: on a shared card this rank's persistent
        buffer of ``key`` (made, and opened by every rank of ``group``,
        on first use), else a new one."""
        if not self._ipc(torch.empty(0, device=device), n):
            return torch.empty(numel, dtype=dtype, device=device)
        entry = self._shared.get((key, group))
        if (entry is None or entry[0].numel() != numel
                or entry[0].dtype != dtype):
            from torch.multiprocessing.reductions import (
                rebuild_cuda_tensor, reduce_tensor)

            mine = torch.empty(numel, dtype=dtype, device=device)
            every: List = [None] * n
            dist.all_gather_object(every, reduce_tensor(mine)[1],
                                   group=group)
            me = dist.get_rank(group)
            entry = (mine, [mine if i == me else rebuild_cuda_tensor(*a)
                            for i, a in enumerate(every)])
            self._shared[(key, group)] = entry
        return entry[0]

    def _peers(self, flat: torch.Tensor, group) -> List[torch.Tensor]:
        """Every rank's buffer of the key ``flat`` is this rank's, once
        every rank wrote its own (a barrier after the card finished)."""
        peers = next(p for (_, g), (mine, p) in self._shared.items()
                     if g is group and mine is flat)
        torch.cuda.synchronize(flat.device)
        dist.barrier(group=group)
        return peers

    def _release(self, flat: torch.Tensor, group) -> None:
        """Wait until every rank has read the buffers."""
        torch.cuda.synchronize(flat.device)
        dist.barrier(group=group)

    def reduce_scatter_flat(self, flat: torch.Tensor, group, n: int,
                            index: int, tail: int = 0):
        """(rank ``index``'s ``1/n`` block of the sum of the ``n`` ranks'
        1-D ``flat`` before its last ``tail`` elements, the sum of those
        ``tail`` elements, which every rank keeps), new tensors: the
        all-reduce SUM, into ``flat`` itself, then the slices.  On a
        shared card (``flat`` from :meth:`shared_flat`) only those two
        slices are summed, with the bits of the whole sum's."""
        per = (flat.numel() - tail) // n
        if not self._ipc(flat, n):
            total = self.all_reduce_sum(flat, group, n, inplace=True)
            return (total[index * per:(index + 1) * per].clone(),
                    total[flat.numel() - tail:].clone())
        self.calls += 1
        self.bytes += flat.numel() * flat.element_size()
        peers = self._peers(flat, group)
        parts = []
        for lo, hi in ((index * per, (index + 1) * per),
                       (flat.numel() - tail, flat.numel())):
            out = peers[0][lo:hi].clone()
            for p in peers[1:]:
                out.add_(p[lo:hi])
            parts.append(out)
        self._release(flat, group)
        return parts[0], parts[1]

    def all_reduce_flat(self, flat: torch.Tensor, group, n: int
                        ) -> torch.Tensor:
        """The sum of the ``n`` ranks' 1-D ``flat``: into ``flat`` through
        the host, or on a shared card (``flat`` from :meth:`shared_flat`)
        a new tensor, the ranks' buffers added in rank order."""
        if not self._ipc(flat, n):
            return self.all_reduce_sum(flat, group, n, inplace=True)
        self.calls += 1
        self.bytes += flat.numel() * flat.element_size()
        peers = self._peers(flat, group)
        out = peers[0].clone()
        for p in peers[1:]:
            out.add_(p)
        self._release(flat, group)
        return out

    def all_gather_flat(self, flat: torch.Tensor, group, n: int
                        ) -> torch.Tensor:
        """The ``n`` ranks' 1-D ``flat`` buffers, concatenated in rank
        order (on a shared card, read from each rank's :meth:`shared_flat`
        buffer)."""
        if not self._ipc(flat, n):
            return self.all_gather(flat, group, n, 0)
        self.calls += 1
        self.bytes += flat.numel() * flat.element_size()
        out = torch.cat(self._peers(flat, group))
        self._release(flat, group)
        return out
