"""The regions of a tensor-parallel train step, as autograd functions.

The serve path's collectives (:class:`~repro_torch.launch.mesh.ServeMesh`'s
``sum``/``gather``) carry no gradients.  A train step over a (data, model)
mesh of ranks needs Megatron's four regions, each a
``torch.autograd.Function`` over one axis of the rank's mesh:

* :func:`copy_to` (Megatron's ``f``): identity forward, all-reduce SUM
  backward.  It marks where a tensor that every rank of the axis holds
  whole (an activation, or a replicated parameter) enters work that each
  rank does on its own shard, so that the shards' partial gradients of it
  are summed.
* :func:`reduce_from` (``g``): all-reduce SUM forward, identity backward:
  the sum of a row-parallel product's partial outputs, or of the ranks'
  shares of an MoE layer's load statistics.
* :func:`gather_from`: all-gather forward along a dim, this rank's slice
  of the gradient backward; the work after it must be the same on every
  rank (the loss over gathered vocab logits).
* :func:`split_to`: this rank's slice forward, all-gather backward: the
  inverse region, where whole heads were computed on every rank and each
  keeps its rows for a row-parallel product.

The vocab-parallel embedding is a masked local lookup under
:func:`reduce_from`, exact because one rank's term is nonzero.
:class:`TrainView` wraps a rank's mesh so that the layers' ``sum`` and
``gather`` over it (written for serving) become :func:`reduce_from` and
:func:`gather_from`; the model code adds :func:`copy_to` where it enters a
split region (:meth:`repro_torch.models.layers.MeshContext.copy`).

The all-reduces are the mesh's own (``Collectives``), counted with the
serve path's; on an axis of one rank every region is the identity.
"""

from __future__ import annotations

import torch


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.sum(g.contiguous(), ctx.axis), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.sum(x.contiguous(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        ctx.size = x.shape[dim]
        return mesh.gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axis)
        return (g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(),
                None, None, None)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        per = x.shape[dim] // mesh.axis_size(axis)
        return x.narrow(dim, mesh.axis_index(axis) * per, per).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.gather(g.contiguous(), ctx.axis, ctx.dim), None, \
            None, None


def _one(mesh, axis: str) -> bool:
    return mesh.axis_size(axis) == 1


def copy_to(x: torch.Tensor, mesh, axis: str = "model") -> torch.Tensor:
    """Identity forward; the gradient summed over ``axis`` backward."""
    return x if _one(mesh, axis) else _Copy.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh, axis: str = "model"
                ) -> torch.Tensor:
    """The sum over ``axis`` forward; the gradient as it is backward."""
    return x if _one(mesh, axis) else _Reduce.apply(x, mesh, axis)


def gather_from(x: torch.Tensor, mesh, axis: str = "model", dim: int = -1
                ) -> torch.Tensor:
    """The ranks' ``x`` concatenated on ``dim`` forward; this rank's slice
    of the gradient backward."""
    if _one(mesh, axis):
        return x
    return _Gather.apply(x, mesh, axis, dim % x.dim())


def split_to(x: torch.Tensor, mesh, axis: str = "model", dim: int = -1
             ) -> torch.Tensor:
    """This rank's ``1/n`` block of ``dim`` forward; the gradient's blocks
    gathered backward."""
    if _one(mesh, axis):
        return x
    return _Split.apply(x, mesh, axis, dim % x.dim())


class TrainView:
    """A rank's mesh as the train step's layers see it: its axes, index
    and size, with ``sum`` and ``gather`` as the differentiable regions
    :func:`reduce_from` and :func:`gather_from`."""

    def __init__(self, mesh):
        self.base = mesh
        self.axis_names = mesh.axis_names

    def axis_size(self, name: str) -> int:
        return self.base.axis_size(name)

    def axis_index(self, name: str) -> int:
        return self.base.axis_index(name)

    def sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        return reduce_from(x, self.base, axis)

    def gather(self, x: torch.Tensor, axis: str, dim: int = 0
               ) -> torch.Tensor:
        return gather_from(x, self.base, axis, dim)
