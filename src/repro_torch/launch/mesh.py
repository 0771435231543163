"""Production mesh builders, the counterpart of ``repro.launch.mesh``.
Functions, not module constants, so importing never touches a process
group.

The dry-run (``launch.dryrun``) builds its meshes over ``torch.distributed``'s
"fake" process group (``start_fake_group``): one process stands for every
rank, collectives do nothing, and the tensors stay on ``meta``. That is the
counterpart of the reference's forced 512 host devices, not a fallback: no
step of a sharded cell runs on a card there, as none runs in the
reference. A mesh on "cuda" is built only when the process group really
has that many ranks, each with its own card.
"""
from __future__ import annotations

from typing import Tuple

SINGLE = ((16, 16), ("data", "model"))
MULTI = ((2, 16, 16), ("pod", "data", "model"))


def _device_type() -> str:
    import torch.distributed as dist
    if dist.get_backend() == "fake":
        return "cpu"
    return "cuda"


def start_fake_group(world_size: int) -> None:
    """Start the fake process group with ``world_size`` ranks (this process
    is rank 0), once per process; a second call with the same size does
    nothing and one with another size raises."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is running; the dry-run needs "
                               f"{world_size} (one process a mesh)")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the running process
    group: "cpu" under the fake group, "cuda" otherwise (one card a
    rank)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    shape, axes = MULTI if multi_pod else SINGLE
    return make_mesh(shape, axes)


def make_test_mesh(n_data: int = 2, n_model: int = 4):
    """Small mesh for unit tests (needs a group of n_data*n_model ranks)."""
    return make_mesh((n_data, n_model), ("data", "model"))


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names`` or any
    object's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """The size of axis ``name``: ``mesh.shape[name]`` on an object whose
    shape is keyed by name, the dim's size on a ``DeviceMesh``."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return int(mesh.size(mesh.mesh_dim_names.index(name)))
    return int(mesh.shape[name])


def data_axes(mesh) -> tuple:
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))
