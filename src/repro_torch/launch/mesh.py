"""Meshes of ranks: a ``DxM`` mesh is ``D*M`` processes in one
``torch.distributed`` group, laid out as a (data, model) grid.

Port of ``repro/launch/mesh.py`` (``MeshShapeError``, ``parse_mesh``,
``make_serve_mesh`` and, for training, ``make_host_mesh(model_axis)``).
Where the reference's mesh is a grid of devices in one process, the
port's is a grid of ranks: rank ``d * M + m`` sits at (d, m), and
:func:`make_serve_mesh` gives each rank a :class:`ServeMesh` with one
subgroup along each axis, its backend and its device.  The train mesh,
:func:`make_train_mesh`, is the same grid over any ``D*M`` ranks of the
group, so that one spawn of ranks carries several meshes (1x1, 2x1 and
1x2 beside its own 2x2) as subgroups.  :func:`spawn` starts the ranks and
runs a function on each.

The backend is chosen explicitly: NCCL only when every rank has a card of
its own, gloo otherwise.  On one card the ranks share it over gloo (NCCL
refuses two ranks on one device), and
:mod:`repro_torch.distributed.collectives` stages their collectives
through host tensors.
"""

from __future__ import annotations

import datetime
import gc
import queue as queue_mod
import socket
import time
import traceback
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.device import resolve_device
from repro_torch.distributed.collectives import Collectives

AXES = ("data", "model")
#: how to start the ranks, named in the errors of a mesh without them
LAUNCH_HINT = ("launch through `python -m repro_torch.launch.serve --mesh "
               "DxM`, `python -m repro_torch.launch.train --mesh DxM` or "
               "`python -m repro_torch.serve.mesh_check`, which spawn the "
               "ranks (repro_torch.launch.mesh.spawn)")


class MeshShapeError(ValueError):
    """A mesh shape that cannot be built here.

    Carries the offending ``shape`` (what was asked for) and ``n_devices``
    (the ranks this process group has) so ``launch.serve --mesh`` failures
    are actionable.
    """

    def __init__(self, message: str, *, shape=None, n_devices=None):
        super().__init__(message)
        self.shape = tuple(shape) if shape is not None else None
        self.n_devices = n_devices


def parse_mesh(spec: str) -> Tuple[int, int]:
    """Parse a ``DxM`` mesh spec ("2x2" -> (2, 2)); raises MeshShapeError."""
    parts = str(spec).lower().split("x")
    try:
        d, m = (int(p) for p in parts)
    except ValueError:
        d = m = 0
    if len(parts) != 2 or d < 1 or m < 1:
        raise MeshShapeError(
            f"mesh spec {spec!r} is not of the form DxM (e.g. '2x2')",
            shape=None,
        )
    return d, m


class MeshShape:
    """The (data, model) axes of a mesh, without ranks: what the sharding
    rules read."""

    axis_names = AXES

    def __init__(self, data: int = 1, model: int = 1):
        if data < 1 or model < 1:
            raise MeshShapeError(
                f"mesh shape ({data}, {model}) has a non-positive axis",
                shape=(data, model))
        self.data = int(data)
        self.model = int(model)

    def axis_size(self, name: str) -> int:
        """The axis' size, 1 for an axis the mesh lacks."""
        return {"data": self.data, "model": self.model}.get(name, 1)

    @property
    def size(self) -> int:
        return self.data * self.model

    def __str__(self) -> str:
        return f"{self.data}x{self.model}"


class ServeMesh(MeshShape):
    """This rank's place in a (data, model) mesh of ranks.

    ``data_index``/``model_index`` are its coordinates.  ``groups[axis]``
    is the subgroup of the ranks that differ from it only along ``axis``:
    ``groups["model"]`` its data row, ``groups["data"]`` its model column.
    ``comm`` runs and counts the collectives; ``device`` is where this
    rank's tensors live.  A mesh over some of the group's ranks
    (:func:`make_train_mesh`) also has ``groups["mesh"]``, all of its
    ranks.
    """

    def __init__(self, data: int, model: int, rank: int, backend: str,
                 device: torch.device, groups: dict):
        super().__init__(data, model)
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self.backend = backend
        self.device = device
        self.groups = groups
        # gloo on CUDA: the ranks share the card (NCCL when each has one)
        self.comm = Collectives(backend, shared_card=backend == "gloo"
                                and device.type == "cuda")

    def axis_index(self, name: str) -> int:
        return {"data": self.data_index,
                "model": self.model_index}.get(name, 0)

    def gather(self, x: torch.Tensor, axis: str, dim: int = 0
               ) -> torch.Tensor:
        """All-gather ``x`` over ``axis``, concatenated on ``dim``."""
        return self.comm.all_gather(x, self.groups.get(axis),
                                    self.axis_size(axis), dim)

    def sum(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """All-reduce SUM of ``x`` over ``axis``."""
        return self.comm.all_reduce_sum(x, self.groups.get(axis),
                                        self.axis_size(axis))

    def max(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """All-reduce MAX of ``x`` over ``axis``."""
        return self.comm.all_reduce_max(x, self.groups.get(axis),
                                        self.axis_size(axis))

    def gather_objects(self, obj) -> list:
        """Every rank of this mesh's picklable ``obj``, in rank order (not
        counted: a report's rows, not the model's work)."""
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.groups.get("mesh"))
        return out


def choose_backend(device, world: int) -> str:
    """NCCL when the ranks run on CUDA and every one has a card of its
    own, gloo otherwise (the CPU, or ranks sharing cards)."""
    dev = torch.device(device)
    if (dev.type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world):
        return "nccl"
    return "gloo"


def make_serve_mesh(data: int = 1, model: int = 1, *, device="cuda"
                    ) -> ServeMesh:
    """This rank's :class:`ServeMesh` over the initialized process group.

    Every rank must call it, with the same shape: it creates the group's
    subgroups, one per data row and one per model column, on every rank
    in the same order.  Raises MeshShapeError, naming how to start the
    ranks, when no group is initialized or its size is not
    ``data * model``.
    """
    shape = MeshShape(data, model)
    need = shape.size
    world = dist.get_world_size() if dist.is_initialized() else 1
    if not dist.is_initialized() or world != need:
        have = (f"the process group has {world} rank(s)"
                if dist.is_initialized() else "no process group is "
                "initialized in this process")
        raise MeshShapeError(
            f"mesh {data}x{model} needs {need} rank(s), {have}; "
            f"{LAUNCH_HINT}", shape=(data, model), n_devices=world)
    rank = dist.get_rank()
    groups = {}
    for d in range(data):  # the data rows: ranks along the model axis
        g = dist.new_group([d * model + m for m in range(model)])
        if rank // model == d:
            groups["model"] = g
    for m in range(model):  # the model columns: ranks along the data axis
        g = dist.new_group([d * model + m for d in range(data)])
        if rank % model == m:
            groups["data"] = g
    return ServeMesh(data, model, rank, dist.get_backend(),
                     resolve_device(device), groups)


def make_train_mesh(data: int = 1, model: int = 1, *, device="cuda",
                    ranks=None) -> Optional[ServeMesh]:
    """This rank's place in a ``data x model`` train mesh over the group's
    ranks ``ranks`` (the first ``data * model`` by default, in increasing
    order), laid out as :func:`make_serve_mesh` lays the whole group; None
    on a rank outside it.  The serve mesh check runs its smaller shapes on
    such meshes too, inside one spawn.  Every rank of the group must call it with the same arguments, in
    the same order as its other calls: each subgroup is created on every
    rank.  Raises MeshShapeError, as :func:`make_serve_mesh` does, when
    the group has fewer ranks than the mesh needs."""
    shape = MeshShape(data, model)
    world = dist.get_world_size() if dist.is_initialized() else 1
    ranks = list(range(shape.size)) if ranks is None else list(ranks)
    if (not dist.is_initialized() or len(ranks) != shape.size
            or max(ranks) >= world):
        have = (f"the process group has {world} rank(s)"
                if dist.is_initialized() else "no process group is "
                "initialized in this process")
        raise MeshShapeError(
            f"mesh {data}x{model} needs {shape.size} rank(s), {have}; "
            f"{LAUNCH_HINT}", shape=(data, model), n_devices=world)
    me = dist.get_rank()
    groups = {}
    rows = [[ranks[d * model + m] for m in range(model)]
            for d in range(data)]
    cols = [[ranks[d * model + m] for d in range(data)]
            for m in range(model)]
    for axis, members in (("model", rows), ("data", cols)):
        if len(members[0]) == 1:  # an axis of one rank runs no collective
            continue
        for group_ranks in members:
            g = dist.new_group(group_ranks)
            if me in group_ranks:
                groups[axis] = g
    if len(ranks) < world:  # the mesh's own group, for its reports
        g = dist.new_group(sorted(ranks))
        if me in ranks:
            groups["mesh"] = g
    if me not in ranks:
        return None
    return ServeMesh(data, model, ranks.index(me), dist.get_backend(),
                     resolve_device(device), groups)


def free_port() -> int:
    """A TCP port of localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_rank(rank: int, world: int, port: int, backend: str = "gloo",
              timeout: float = 600.0) -> None:
    """Join the process group of ``world`` ranks at ``localhost:port``; a
    collective that waits longer than ``timeout`` seconds raises, so a
    rank that dies does not leave the others blocked."""
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))


def _rank_main(rank, data, model, port, backend, device, fn, inputs,
               timeout, results) -> None:
    args = ()
    try:
        # the arguments come through a queue, not the process's own
        # arguments, so that this frame holds their only reference here
        args = inputs.get(timeout=timeout)
        init_rank(rank, data * model, port, backend, timeout)
        if backend == "nccl":  # a card of its own
            torch.cuda.set_device(rank)
            device = f"cuda:{rank}"
        # the ranks share the host's cores: without a share each, their
        # thread pools spin against each other
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // (data * model)))
        out = fn(make_serve_mesh(data, model, device=device), *args)
        results.put((rank, True, out if rank == 0 else None))
    except Exception:  # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))
    finally:
        # release the parent's tensors shared through CUDA IPC before the
        # process ends (it skips the collection of reference cycles), so
        # that the parent can free their memory
        del args
        gc.collect()
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable[..., Any], data: int, model: int, *args,
          device="cuda", timeout: float = 600.0, build: bool = True,
          collective_timeout: Optional[float] = None) -> Any:
    """Run ``fn(mesh, *args)`` on each rank of a ``data x model`` mesh of
    new processes, and return rank 0's result.

    ``fn`` and ``args`` are pickled (``fn`` by import path).  On CUDA the
    kernel libraries are built here first, so the ranks only load them
    (``build=False`` skips that, for work that launches no kernel).
    The ranks' collectives time out after ``collective_timeout`` seconds
    (``timeout`` unless given), the whole call after ``timeout``: then, or when a rank raises or dies, every rank is
    stopped and a RuntimeError carries what went wrong.  Each rank drops
    its arguments before it ends, and on CUDA the memory the ranks shared
    is then collected here (``torch.cuda.ipc_collect``), so tensors passed
    to the ranks hold no card memory once their last owner here drops
    them.
    """
    import multiprocessing as mp

    shape = MeshShape(data, model)
    world = shape.size
    if build and torch.device(device).type == "cuda":
        from repro_torch.kernels import build as kernels
        kernels.build()
    backend = choose_backend(device, world)
    port = free_port()
    ctx = mp.get_context("spawn")
    results, inputs = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(rank, data, model, port, backend, device, fn,
                               inputs, collective_timeout or timeout,
                               results))
             for rank in range(world)]
    for p in procs:
        p.start()
        inputs.put(args)
    deadline = time.monotonic() + timeout
    reported: dict = {}
    failure: Optional[str] = None
    try:
        while len(reported) < world and failure is None:
            if time.monotonic() > deadline:
                failure = f"mesh {shape} did not finish in {timeout} s"
                break
            try:
                rank, ok, payload = results.get(timeout=0.5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in reported]
                if dead:
                    failure = (f"rank(s) {dead} of mesh {shape} exited "
                               f"with {[procs[r].exitcode for r in dead]}")
                continue
            reported[rank] = payload
            if not ok:
                failure = f"rank {rank} of mesh {shape} failed:\n{payload}"
    finally:
        for p in procs:
            p.join(timeout=5 if failure is None else 0.1)
            if p.is_alive():
                p.terminate()
                p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
        if torch.device(device).type == "cuda":
            torch.cuda.ipc_collect()  # the memory the ranks shared
    if failure is not None:
        raise RuntimeError(failure)
    return reported[0]
