"""Mesh records (the port of ``repro/launch/mesh.py``).

A :class:`Mesh` is a plain record of axis names and sizes.  The
production meshes are abstract: they exist to compute sharding rules and
per-device sizes (:mod:`repro_torch.parallel.sharding`,
:mod:`repro_torch.launch.dryrun`), and no card backs them.  The host mesh
is the one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


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


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The abstract ``(16, 16)`` data x model mesh, or ``(2, 16, 16)``
    pod x data x model with ``multi_pod``."""
    if multi_pod:
        return Mesh.of((2, 16, 16), ("pod", "data", "model"))
    return Mesh.of((16, 16), ("data", "model"))


def make_host_mesh(model_parallel: int = 1) -> Mesh:
    """The one card as a ``(1, 1)`` data x model mesh.  One card has no
    model-parallel axis: any ``model_parallel`` but 1 raises."""
    if model_parallel != 1:
        raise ValueError("one card has no mesh to split: model_parallel "
                         f"must be 1, got {model_parallel}")
    return Mesh.of((1, 1), ("data", "model"))
