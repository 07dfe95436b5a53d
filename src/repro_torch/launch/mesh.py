"""Meshes (the port of ``repro/launch/mesh.py``).

A :class:`Mesh` is a plain record of axis names and sizes.  The
production meshes are abstract: they exist to compute sharding rules and
per-device sizes (:mod:`repro_torch.parallel.sharding`,
:mod:`repro_torch.launch.dryrun`), and no card backs them.  The host mesh
is real: a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
process group, one rank per card (NCCL between cards, gloo between CPU
processes), with the reference's ``("data", "model")`` axes.  Every
sharding function takes either kind (:func:`as_record`).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """Axis names in order and each axis's size."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]

    @classmethod
    def of(cls, sizes, names) -> "Mesh":
        sizes, names = tuple(int(s) for s in sizes), tuple(names)
        if len(sizes) != len(names):
            raise ValueError(f"{len(sizes)} sizes for axes {names}")
        return cls(names, dict(zip(names, sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def as_record(mesh) -> Mesh:
    """``mesh`` as a :class:`Mesh` record: a record as it is, a
    ``DeviceMesh`` by its dimension names and sizes."""
    if isinstance(mesh, Mesh):
        return mesh
    return Mesh.of(mesh.shape, mesh.mesh_dim_names)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract ``(16, 16)`` data x model mesh, or ``(2, 16, 16)``
    pod x data x model with ``multi_pod``."""
    if multi_pod:
        return Mesh.of((2, 16, 16), ("pod", "data", "model"))
    return Mesh.of((16, 16), ("data", "model"))


def init_group(device=None) -> torch.device:
    """Join the process group if it is not formed yet, and return this
    rank's device.  Under ``torchrun`` (``WORLD_SIZE`` in the environment)
    the group is every launched rank, read from the environment; otherwise
    it is a group of one.  NCCL on the card, gloo only when the caller asked
    for the CPU: a group that cannot form raises, nothing falls back."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dev


def make_host_mesh(model_parallel: int = 1, device=None):
    """A ``("data", "model")`` ``DeviceMesh`` of shape ``(world // mp,
    mp)`` over every rank of the process group (formed by
    :func:`init_group` when there is none).  ``model_parallel`` must
    divide the world size, as the reference asserts."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = init_group(device)
    world = dist.get_world_size()
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"model_parallel {model_parallel} does not divide "
                         f"the {world} ranks of the process group")
    return init_device_mesh(dev.type, (world // model_parallel,
                                       model_parallel),
                            mesh_dim_names=("data", "model"))


def close_group() -> None:
    """Leave the process group, if one is formed."""
    if dist.is_initialized():
        dist.destroy_process_group()
