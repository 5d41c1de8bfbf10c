"""Meshes a step's shardings are laid on.

The port's copy of ``repro/launch/mesh.py``.  A ``Mesh`` is axis names and
sizes and nothing else, as JAX's ``AbstractMesh``: the dry run lays its
shardings on such records without touching a device.  The production
meshes describe the reference's pods; ``one_card_mesh`` describes one H100.
``device_mesh`` makes a ``torch.distributed`` DeviceMesh of a record over
an initialised process group, the mesh ``parallel/partition.py`` runs a
cell on."""

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


def device_mesh(mesh: Mesh, device=None):
    """The ``torch.distributed`` DeviceMesh of ``mesh`` on ``device``'s type
    (None: CUDA, under the port's device rule), its dimensions named and
    sized as the mesh's axes.  It needs an initialised process group of
    ``mesh.size`` processes on the device's backend (NCCL for CUDA, gloo
    for the CPU, which a caller asks for with ``device="cpu"``), and raises
    without one: it never makes a world of one by itself."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.ops import resolve_device
    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("device_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    want = "nccl" if dev.type == "cuda" else "gloo"
    backend = str(dist.get_backend()).lower()
    if want not in backend.split(":") and want not in backend:
        raise RuntimeError(f"a {dev.type} mesh runs over {want}; the process "
                           f"group's backend is {backend}")
    if dist.get_world_size() != mesh.size:
        raise RuntimeError(f"mesh {mesh.name or mesh.axis_names} has "
                           f"{mesh.size} devices, the process group "
                           f"{dist.get_world_size()} processes")
    return init_device_mesh(dev.type, mesh.axis_sizes,
                            mesh_dim_names=mesh.axis_names)
