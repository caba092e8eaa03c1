"""Worker mesh of the port on ``torch.distributed``; the port of
``repro/launch/mesh.py::make_worker_mesh``.

The reference lays the DiPaCo workers along the "data" axis of a device
mesh (``gcd(W, devices)`` devices, each holding ``W / n`` worker rows).
Here the devices are the ranks of a process group: each rank holds its
own ``W // world`` rows of every worker-stacked tree, in rank order, and
the fragment reduce (``launch/steps.py``) gathers the rows of the others
with ``dist.all_gather``.

Where a process group exists (``torchrun``, or a caller's own
``init_process_group``) the mesh joins it.  Where none exists it makes a
world of one from a ``dist.HashStore()``: the reference's (1, 1) mesh,
the same code path with no collective crossing a process.  That world is
made once, kept for the process and destroyed at its exit; the mesh
never destroys a group it did not make.
"""
from __future__ import annotations

import atexit
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def world_backend(device, world_size: int) -> str:
    """The process-group backend for ranks on ``device``: NCCL only where
    each of the ``world_size`` ranks has a card of its own, gloo on the
    CPU and where ranks share a card (NCCL refuses two ranks on one
    device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@dataclass(frozen=True)
class WorkerMesh:
    """One rank's view of the worker mesh: ``world`` ranks along the
    reference's "data" axis ("model" is 1), this rank's index, the device
    its tensors live on, the group's backend and the group itself
    (``None`` is the default world), and the worker rows it holds."""

    world: int
    rank: int
    device: torch.device
    backend: str
    group: object
    num_workers: int

    axis_names = ("data", "model")

    @property
    def shape(self) -> dict:
        return {"data": self.world, "model": 1}

    @property
    def rows_per_rank(self) -> int:
        return self.num_workers // self.world

    @property
    def rows(self) -> range:
        n = self.rows_per_rank
        return range(self.rank * n, (self.rank + 1) * n)


@dataclass(frozen=True)
class LogicalMesh:
    """A device mesh known only by its axes and their sizes: what the
    dry-run (``launch/specs.py``, ``launch/dryrun.py``) lays its specs
    over.  It holds no device and no process group."""

    axis_names: tuple
    sizes: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> LogicalMesh:
    """16x16 = 256 devices a pod; multi_pod adds a leading 2-pod axis."""
    if multi_pod:
        return LogicalMesh(("pod", "data", "model"), (2, 16, 16))
    return LogicalMesh(("data", "model"), (16, 16))


def make_worker_mesh(num_workers: int, *, device="cuda") -> WorkerMesh:
    """The worker mesh for ``num_workers`` DiPaCo workers on ``device``.

    Joins the process group that exists, whose size must divide
    ``num_workers``; otherwise makes a world of one (NCCL for a CUDA
    device, gloo for the CPU) that later meshes of the process join."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    W = int(num_workers)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
        atexit.register(_destroy_if_default, dist.group.WORLD)
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = str(dist.get_backend())
    if W % world:
        raise ValueError(f"the process group's {world} ranks do not "
                         f"divide the {W} workers")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the process group runs NCCL, which cannot "
                         f"hold tensors on {device}")
    return WorkerMesh(world=world, rank=rank, device=device, backend=backend,
                      group=None, num_workers=W)


def _destroy_if_default(group) -> None:
    """Destroy the world of one a mesh made, if it is still the default
    group (the caller may have destroyed or replaced it)."""
    if dist.is_initialized() and dist.group.WORLD is group:
        dist.destroy_process_group()


def worker_axes(mesh) -> tuple:
    """Mesh axes that enumerate DiPaCo path-workers (islands)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def num_workers(mesh) -> int:
    """The ranks along the worker axes (the reference's device count of
    the mesh's worker axes)."""
    n = 1
    for a in worker_axes(mesh):
        n *= mesh.shape[a]
    return n
