"""Partitioning rules: DP / TP / EP / SP over the production mesh.

The port of ``repro.sharding.partitioning``, rule for rule:

  * **data axis (+ pod axis when multi-pod)**: the batch dimension of
    every activation.
  * **model axis**: tensor parallelism where divisibility is universal
    across the fleet: d_ff, vocab (parallel unembed + CE), experts (EP),
    and the fused ``heads*head_dim`` projection columns.
  * **ZeRO-3 storage**: every >= 2-D parameter also shards its first
    dimension over the data axis.
  * **SP for serving**: decode-shape KV caches shard the *sequence* axis
    over the model axis (and over data too at batch 1).

A spec is what a JAX ``PartitionSpec`` holds: a tuple with, for each
tensor dim, an axis name, a tuple of names or None (``()``: replicated).
A mesh is anything with named axes and sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and
``shape``), :class:`repro_torch.launch.mesh.AbstractMesh`, an object with
an ``axis_names`` tuple and a ``shape`` mapping, or a mapping from names to
sizes.  :func:`shard_shape` gives a spec's per-device shape and
:func:`to_placements` its DTensor placements.

The port's parameters are a per-layer list (``layers.<i>.<...>``), not the
JAX ``scan`` stack, so the JAX rule for stacked leaves (replicate the
leading cycle axis, apply the rules to the rest) has no case here: layer
``i``'s leaf takes the inner spec directly.  Nothing here creates a
process group.
"""

from __future__ import annotations

import math
from typing import Any, Mapping

from repro_torch.configs.base import ModelConfig

Spec = tuple


# --------------------------------------------------------------------------
# mesh helpers
# --------------------------------------------------------------------------


def mesh_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of any mesh this module takes, in mesh order."""
    if hasattr(mesh, "mesh_dim_names"):                 # DeviceMesh
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes that carry the batch dimension (pod DP + in-pod DP)."""
    names = mesh_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _fits(mesh, dim: int, axes) -> bool:
    return dim % axis_size(mesh, axes) == 0


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------


def _leaf_name(path) -> str:
    """The last key of a dotted name (``layers.3.attn.wq`` -> ``wq``) or of
    a sequence of keys."""
    parts = path.split(".") if isinstance(path, str) else [str(p)
                                                           for p in path]
    return parts[-1] if parts else ""


def param_pspec(path, leaf, mesh, *, zero3: bool = True) -> Spec:
    """Spec of one parameter leaf (anything with a ``shape``) named
    ``path`` (see module docstring)."""
    name = _leaf_name(path)
    shape = tuple(leaf.shape)
    nd = len(shape)
    dp = "data" if (zero3 and "data" in mesh_sizes(mesh)) else None

    if nd <= 1:
        return ()
    if name == "embed":                       # (V, D)
        return ("model" if _fits(mesh, shape[0], "model") else None,
                dp if _fits(mesh, shape[1], dp) else None)
    if name == "lm_head":                     # (D, V)
        return (dp if _fits(mesh, shape[0], dp) else None,
                "model" if _fits(mesh, shape[1], "model") else None)
    if name == "router":
        return (None, None)
    if nd == 3:                               # expert weights (E, ., .)
        e_ok = _fits(mesh, shape[0], "model")
        d_ok = _fits(mesh, shape[1], dp)
        return ("model" if e_ok else None, dp if d_ok else None, None)
    # generic 2-D: ZeRO-3 on dim0, TP on dim1
    d0 = dp if _fits(mesh, shape[0], dp) else None
    d1 = "model" if _fits(mesh, shape[1], "model") else None
    return (d0, d1)


def param_shardings(named: Mapping[str, Any], mesh, *,
                    zero3: bool = True) -> dict[str, Spec]:
    """{name: spec} of named leaves (a module's ``named_parameters()``, or
    the AdamW moments by the same names)."""
    return {k: param_pspec(k, t, mesh, zero3=zero3) for k, t in named.items()}


# --------------------------------------------------------------------------
# step input / output rules
# --------------------------------------------------------------------------


def _batch_dim_axes(mesh, b: int):
    dp = batch_axes(mesh)
    if b % axis_size(mesh, dp) == 0:
        return dp
    return "data" if b % axis_size(mesh, "data") == 0 else None


def batch_shardings(mesh, batch: Mapping[str, Any]) -> dict[str, Spec]:
    """Batch dict (tokens/labels/frontend_embeds): batch dim over DP
    axes."""
    return {k: (_batch_dim_axes(mesh, leaf.shape[0]),
                *([None] * (len(leaf.shape) - 1)))
            for k, leaf in batch.items()}


def cache_pspec(cfg: ModelConfig, mesh, layer: int, field: str,
                shape: tuple[int, ...], *, long: bool) -> Spec:
    """Serving-cache sharding: SP on global-KV sequence, DP on batch."""
    kind = cfg.block_kind(layer)
    b_axes = _batch_dim_axes(mesh, shape[0])
    names = mesh_sizes(mesh)

    if kind == "global" and field in ("k", "v"):
        seq_axes: Any = "model"
        if b_axes is None:                    # batch 1: give seq both axes
            seq_axes = tuple(a for a in ("pod", "data", "model")
                             if a in names)
        if shape[1] % axis_size(mesh, seq_axes) == 0:
            return (b_axes, seq_axes, None, None)
        return (b_axes, None, None, None)
    if kind == "local" and field in ("k", "v"):
        return (b_axes, None, None, None)
    if kind == "rwkv" and field == "state":
        h_ok = shape[1] % axis_size(mesh, "model") == 0
        return (b_axes, "model" if h_ok else None, None, None)
    if kind == "rglru":
        if field == "h":
            w_ok = shape[1] % axis_size(mesh, "model") == 0
            return (b_axes, "model" if w_ok else None)
        if field == "conv":
            w_ok = shape[2] % axis_size(mesh, "model") == 0
            return (b_axes, None, "model" if w_ok else None)
    # token-shift carries etc.
    return (b_axes, *([None] * (len(shape) - 1)))


def cache_shardings(cfg: ModelConfig, mesh, cache: list, *,
                    long: bool = False) -> list[dict[str, Spec]]:
    return [{f: cache_pspec(cfg, mesh, i, f, tuple(v.shape), long=long)
             for f, v in slot.items()} for i, slot in enumerate(cache)]


def logits_sharding(cfg: ModelConfig, mesh, batch: int) -> Spec:
    v_ok = cfg.vocab_size % axis_size(mesh, "model") == 0
    return (_batch_dim_axes(mesh, batch), "model" if v_ok else None)


def replicated(mesh) -> Spec:
    return ()


# --------------------------------------------------------------------------
# per-device shapes and DTensor placements
# --------------------------------------------------------------------------


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(global_shape, spec: Spec, mesh) -> tuple[int, ...]:
    """The per-device shape of a tensor of ``global_shape`` laid out by
    ``spec``: each dim divided by the product of its axes' sizes (rounded
    up: the first device's shard, as DTensor's ``Shard`` cuts it)."""
    shape = tuple(int(d) for d in global_shape)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than shape {shape}")
    out = list(shape)
    for i, entry in enumerate(spec):
        out[i] = -(-shape[i] // axis_size(mesh, _axes_of(entry) or None))
    return tuple(out)


def to_placements(spec: Spec, mesh, shape=None) -> tuple:
    """The DTensor placements of ``spec``: for each mesh dim, in mesh
    order, ``Shard(d)`` if tensor dim ``d`` takes that axis, else
    ``Replicate()``.  A tensor dim over several axes must list them in mesh
    order (row-major, as ``PartitionSpec(("data", "model"))``), which is
    how DTensor orders two shardings of one dim.  Given the tensor's
    ``shape``, a dim of size 1 stays replicated (the rules shard it only
    over axes of size 1, where it is whole either way, and DTensor cannot
    view a sharded dim of size 1 away)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_sizes(mesh))
    owner: dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        if [names.index(a) for a in axes] != sorted(
                names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: the axes of dim {d} are not in "
                             f"the mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {spec} uses axis {a!r} twice")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner and (
        shape is None or shape[owner[a]] != 1) else Replicate()
        for a in names)


# --------------------------------------------------------------------------
# laying a tree out as DTensors, and gathering it back
# --------------------------------------------------------------------------


def is_spec(s) -> bool:
    """True for one spec (a tuple of axis names, tuples of names and
    None), as opposed to a tree of specs."""
    return isinstance(s, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in s)


def distribute_tensor(t, spec: Spec, mesh):
    """``t`` (the global tensor, the same on every rank) as a DTensor laid
    out by ``spec`` over the ``DeviceMesh``: this rank's shard, cut
    locally with no collective.  A meta tensor gives a meta shard of
    :func:`shard_shape`'s size; a real one a view where the shard is the
    whole tensor (a one-rank mesh copies nothing), else a contiguous copy
    of the slice.  A DTensor is redistributed to ``spec``."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    placements = to_placements(spec, mesh, t.shape)
    if isinstance(t, DTensor):
        if tuple(t.placements) == placements:
            return t
        return t.redistribute(mesh, placements)
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, placements)
    if t.is_meta:
        local = torch.empty(shape, dtype=t.dtype, device=t.device)
    else:
        local = t
        for d, (o, n) in enumerate(zip(offset, shape)):
            if n != t.shape[d]:
                local = local.narrow(d, o, n)
        local = local.contiguous()
    out = DTensor.from_local(local, mesh, placements, run_check=False,
                             shape=t.shape, stride=t.stride())
    return out.requires_grad_(t.requires_grad) if t.is_leaf else out


def distribute(tree, specs, mesh):
    """``tree`` laid out as DTensors by ``specs`` (the same structure, or
    one spec for every tensor of a subtree): the counterpart of placing a
    ``jax.jit`` argument by its ``in_shardings``.  Tensors, dicts, lists,
    tuples and dataclasses (the train and grow states) give new
    containers; a module (a model's parameters, ``specs`` a mapping from
    parameter names) is changed in place, each parameter replaced by a
    parameter holding its DTensor, and returned.  Anything else (an int
    step, None) passes through."""
    import dataclasses

    import torch
    from torch import nn
    from torch.distributed.tensor import DTensor

    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, specs, mesh)
    if isinstance(tree, nn.Module):
        for name, p in list(tree.named_parameters()):
            mod, _, leaf = name.rpartition(".")
            owner = tree.get_submodule(mod) if mod else tree
            spec = specs if is_spec(specs) else specs[name]
            if not (isinstance(p, DTensor) and tuple(p.placements)
                    == to_placements(spec, mesh, p.shape)):
                owner._parameters[leaf] = nn.Parameter(
                    distribute_tensor(p.detach(), spec, mesh),
                    requires_grad=p.requires_grad)
        return tree
    if is_spec(specs) and isinstance(tree, (dict, list)):
        specs = (type(tree)(dict.fromkeys(tree, specs))
                 if isinstance(tree, dict) else [specs] * len(tree))
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(distribute(v, s, mesh)
                          for v, s in zip(tree, specs))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: distribute(getattr(tree, f.name),
                               specs if is_spec(specs)
                               else getattr(specs, f.name), mesh)
            for f in dataclasses.fields(tree) if f.init})
    return tree


def gather(tree):
    """Every DTensor of ``tree`` as its full tensor (``full_tensor``: a
    collective over its mesh), through the containers :func:`distribute`
    takes; a module's parameters are returned as a {name: tensor} dict."""
    import dataclasses

    import torch
    from torch import nn
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, nn.Module):
        return {k: gather(p.detach()) for k, p in tree.named_parameters()}
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather(v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: gather(getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree
