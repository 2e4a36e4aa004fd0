"""Mesh construction: the port of ``repro.launch.mesh``.

:func:`make_mesh` is a ``torch.distributed`` device mesh over an
initialised process group: importing the module touches no device and no
environment variable and makes no group.  The caller starts the group
(``torch.distributed.init_process_group`` with its address, world size and
rank); a mesh of more than one device without one raises.
:func:`fake_mesh` makes its own group, torch's fake one of the mesh's size
in this one process, and destroys it on exit: the dry run's mesh.

:class:`AbstractMesh` is named axes and their sizes with no devices behind
them: what the partitioning rules and the meta dry run need, and the
counterpart of the JAX dry run's faked 512-device host mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, in mesh order; no devices."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def desc(self) -> str:
        return "x".join(str(s) for s in self.sizes)


def abstract_mesh(shape, axes) -> AbstractMesh:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    return AbstractMesh(tuple(axes), tuple(int(s) for s in shape))


def make_mesh(shape, axes, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with ``axes`` as its dim names over the
    initialised default process group, whose world size must be the
    mesh's size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"a {'x'.join(map(str, shape))} mesh needs an initialised "
            f"process group of {n} ranks: call "
            f"torch.distributed.init_process_group(init_method="
            f"'tcp://localhost:<port>', world_size={n}, rank=<rank>) first")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {n} devices needs a world of {n} "
                           f"ranks, got {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def production_shape(*, multi_pod: bool = False
                     ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """The JAX package's pod grid: (data=16, model=16) per pod, and a
    'pod' axis across two pods."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The pod grid as a ``DeviceMesh`` (256 or 512 ranks)."""
    return make_mesh(*production_shape(multi_pod=multi_pod), device_type)


def make_host_mesh(data: int = 2, model: int = 4, device_type: str = "cpu"):
    """A small (data, model) mesh over host devices (tests; the group's
    world size must be ``data * model``)."""
    return make_mesh((data, model), ("data", "model"), device_type)


@contextlib.contextmanager
def fake_mesh(shape, axes, device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over torch's fake process group of
    ``prod(shape)`` ranks, as rank 0, in this one process: the counterpart
    of the JAX dry run's ``--xla_force_host_platform_device_count``.  A
    collective on it moves nothing and returns an empty result of the
    right shape, so a step on meta tensors laid out over it runs as rank
    0 would, each op on rank 0's shards.  The group is made on entry and
    destroyed on exit; it raises if a group is already initialised."""
    import torch.distributed as dist
    # registers the "fake" backend (made only here, never at import)
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already "
                           "initialised")
    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield make_mesh(shape, axes, device_type)
    finally:
        dist.destroy_process_group()
