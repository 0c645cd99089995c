"""The mesh plan: how model code lays its work onto a mesh.

Port of ``repro/distributed/context.py``, as far as the port's MoE reads
it.  Model modules are mesh-agnostic; a launcher activates a
:class:`MeshPlan` around the model's calls (:func:`use_plan`), and
:mod:`repro_torch.models.moe` reads it (:func:`current`) to pick its
hierarchical or shard_map dispatch.  The default plan is inactive, so
tests and single-device runs never see one.

The plan's ``mesh`` is a :class:`~repro_torch.launch.mesh.MeshShape` (axis
sizes, no ranks; the MoE layouts then compute every data shard in this one
process) or a rank's mesh of a train mesh of ranks
(:func:`~repro_torch.launch.mesh.make_train_mesh`; the layouts then run
across the ranks, ``models.moe._moe_ffn_ranks``).  The reference's
sequence-parallel residual layout (``seq_parallel``, ``shard_seq``) and
its sharding hints (``constrain``) change no value and nothing on the
trainer's path sets them; they come with the dry-run cells (ROADMAP item
1.19), which do.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional, Tuple

#: MoE layouts a plan may select
MOE_IMPLS = ("global", "hierarchical", "shard_map")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    n_data: int = 1                      # product of the data axes' sizes
    n_model: int = 1
    data_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    moe_impl: str = "global"             # one of MOE_IMPLS
    mesh: Optional[object] = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {self.moe_impl!r} not in {MOE_IMPLS}")

    @property
    def moe_hierarchical(self) -> bool:
        return self.moe_impl == "hierarchical"

    @property
    def active(self) -> bool:
        return bool(self.data_axes) or self.model_axis is not None


_PLAN: contextvars.ContextVar[MeshPlan] = contextvars.ContextVar(
    "repro_torch_mesh_plan", default=MeshPlan())


def current() -> MeshPlan:
    return _PLAN.get()


@contextlib.contextmanager
def use_plan(plan: MeshPlan):
    token = _PLAN.set(plan)
    try:
        yield plan
    finally:
        _PLAN.reset(token)


def plan_for_mesh(mesh, *, moe_impl: str = "global") -> MeshPlan:
    """The plan of ``mesh`` (anything with ``axis_names`` and
    ``axis_size``, a train mesh of ranks included): its ``pod``/``data``
    axes as the data axes, ``model`` as the model axis."""
    names = tuple(mesh.axis_names)
    data_axes = tuple(a for a in ("pod", "data") if a in names)
    n_data = 1
    for a in data_axes:
        n_data *= mesh.axis_size(a)
    has_model = "model" in names
    return MeshPlan(
        n_data=n_data,
        n_model=mesh.axis_size("model") if has_model else 1,
        data_axes=data_axes,
        model_axis="model" if has_model else None,
        moe_impl=moe_impl,
        mesh=mesh,
    )
