"""The kernels' custom ops under DTensor: sharding strategies and the CPU
kernels that a DTensor's CPU shards reach.

Each kernel module registers, beside its custom op, the layouts the op
takes and gives for one mesh dimension (:func:`register_sharding`, torch's
``register_sharding``, which expands them over every mesh dimension).  A
DTensor argument then runs the op on each rank's shards, after DTensor has
redistributed the inputs to the cheapest of those layouts: the launch is
the kernel's, on the shards, and never the plain version of a global
tensor.  An op with no strategy raises under DTensor.

The ops' own kernels are CUDA ones.  A DTensor whose shards lie on the CPU
(the tests' ``gloo`` meshes) reaches the op's CPU kernel, registered by
:func:`register_cpu`: the kernel's plain version on the shards, which is
what a wrapper runs on a plain CPU tensor.  A plain CPU tensor never
reaches the op (the wrappers refuse it).

Nothing here makes a process group; importing registers the strategies
only (``torch.distributed`` is imported, not initialised).
"""

from __future__ import annotations

from typing import Callable

import torch


def is_dtensor(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def register_sharding(ops) -> Callable:
    """``torch.distributed.tensor.experimental.register_sharding(ops)``,
    or nothing where torch has no ``torch.distributed``."""
    def deco(fn):
        if torch.distributed.is_available():
            from torch.distributed.tensor.experimental import (
                register_sharding as reg)
            reg(ops)(fn)
        return fn
    return deco


def register_cpu(op) -> Callable:
    """The op's CPU kernel (its plain version), reached only through a
    DTensor's CPU shards."""
    def deco(fn):
        op.register_kernel("cpu")(fn)
        return fn
    return deco


def placements():
    """(Replicate(), Shard, Partial()) for the strategies."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return Replicate(), Shard, Partial()


def divides(mesh, *dims: int) -> bool:
    """True when every dim divides by the mesh's size: a dim sharded over
    any set of its axes then splits evenly (register_sharding cannot tell
    a strategy which mesh dims it is expanded over)."""
    n = mesh.size()
    return all(d % n == 0 for d in dims)
