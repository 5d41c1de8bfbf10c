"""Meshes the dry run lays its shardings on.

The port's copy of ``repro/launch/mesh.py``.  A ``Mesh`` is axis names and
sizes and nothing else, as JAX's ``AbstractMesh``: the port has no
partitioner, so no mesh here holds devices or makes a process group.  The
production meshes describe the reference's pods; ``one_card_mesh``
describes one H100, the mesh whose cells the port can run."""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    name: str = ""

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} against {self.axis_sizes}")

    @property
    def shape(self) -> dict[str, int]:
        """{axis name: size}, in axis order (as JAX's ``mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        """Number of devices."""
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
    data=16, model=16) = 512; the pod axis extends data parallelism across
    pods."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16), "pod2x16x16")
    return Mesh(("data", "model"), (16, 16), "pod16x16")


def one_card_mesh() -> Mesh:
    """(data=1, model=1): one H100, named ``h100x1``."""
    return Mesh(("data", "model"), (1, 1), "h100x1")


def data_shards(mesh) -> int:
    """Number of data-parallel shards (pod x data axes)."""
    sizes = dict(mesh.shape)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def model_shards(mesh) -> int:
    return dict(mesh.shape).get("model", 1)
