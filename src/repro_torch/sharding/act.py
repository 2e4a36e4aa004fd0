"""Activation sharding constraints (propagation anchors).

The port of ``repro.sharding.act``.  The JAX package pins activations with
``with_sharding_constraint`` where XLA's propagation loses the batch axis;
these helpers ask for the same spec for the same shape and knobs, and the
port's models call them where the JAX package's do (``layers.qkv`` and
``mlp_apply``, ``transformer.embed_tokens``, the KV capture and the
per-cycle re-anchor, the chunked CE's logits, the MoE's expert tensors,
the frontier's histogram).  :func:`_constrain` redistributes a DTensor to
the spec's placements over its own mesh (a partitioned step) and is the
identity on a plain tensor, so on one device every helper returns its
input and no count or result moves.

A few more calls pin what DTensor, unlike GSPMD, cannot carry through an
op: a projection before its view as heads, the attention output before
``wo``, RWKV's branches, and the CE's gathered gold logit (``shard_batch``
in each, listed in ``CHANGES.md``).

The active mesh geometry is process-global, set by the launch layer
(``launch.specs.run_cell_step``) via :func:`activation_sharding`; with no
context active every helper is a no-op.  Axes are applied only when the
dimension is divisible, e.g. batch 1 at ``long_500k`` stays replicated.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

_STATE = {"dp": ("data",), "tp": "model", "dp_size": 1, "tp_size": 1,
          "enabled": False,
          # --- layout knobs (hillclimbed in the JAX package) --------------
          "moe2d": False,    # shard MoE capacity axis over DP
          "yadt_rs": True,   # reduce-scatter the frontier histogram over K
          "yadt_compact": True,  # keep compacted live-case buffers DP-sharded
          "kv_seq_shard": False,  # capture prefill KV seq-sharded over TP
          }


@contextlib.contextmanager
def activation_sharding(dp: Sequence[str], dp_size: int,
                        tp: str = "model", tp_size: int = 1, **knobs):
    old = dict(_STATE)
    _STATE.update(dp=tuple(dp), tp=tp, dp_size=int(dp_size),
                  tp_size=int(tp_size), enabled=True, **knobs)
    try:
        yield
    finally:
        _STATE.clear()
        _STATE.update(old)


def from_mesh(mesh, **knobs):
    from repro_torch.sharding import partitioning as part
    dp = part.batch_axes(mesh)
    return activation_sharding(
        dp, part.axis_size(mesh, dp), "model",
        part.mesh_sizes(mesh).get("model", 1), **knobs)


def _constrain(x, spec: tuple):
    """``x`` laid out by ``spec``: a DTensor is redistributed over its
    mesh; any other tensor is returned as it is (no mesh in scope)."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    from repro_torch.sharding import partitioning as part
    return x.redistribute(x.device_mesh,
                          part.to_placements(spec, x.device_mesh, x.shape))


def replicate(x):
    """A DTensor replicated on every mesh dim (GSPMD's replication of an
    op it cannot partition); any other tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim)


def _dp_for(dim: int):
    return _STATE["dp"] if dim % max(_STATE["dp_size"], 1) == 0 else None


def _tp_for(dim: int):
    return _STATE["tp"] if dim % max(_STATE["tp_size"], 1) == 0 else None


def shard_batch(x):
    """Pin dim0 = batch to the DP axes; other dims replicated."""
    if not _STATE["enabled"]:
        return x
    return _constrain(x, (_dp_for(x.shape[0]), *([None] * (x.ndim - 1))))


def shard_batch_tp_last(x):
    """Pin (batch, ..., feature): batch to DP, last dim to TP."""
    if not _STATE["enabled"]:
        return x
    return _constrain(x, (_dp_for(x.shape[0]), *([None] * (x.ndim - 2)),
                          _tp_for(x.shape[-1])))


def shard_frontier_hist(x):
    """(K, A, B+1, C) frontier histogram: replicated, or with ``yadt_rs``
    the slot axis K over TP (the partials reduce-scattered)."""
    if not (_STATE["enabled"] and _STATE["yadt_rs"]):
        return x
    return _constrain(x, (_tp_for(x.shape[0]), *([None] * (x.ndim - 1))))


def active_cases_sharded() -> bool:
    """Whether the compacted live cases stay with their rank's shard
    (``yadt_compact``, the default; no context: yes)."""
    return not _STATE["enabled"] or _STATE["yadt_compact"]


def shard_active_cases(x):
    """Compacted live-case buffers ``(N_active,)`` / ``(N_active, A)``:
    dim0 on the DP axes under ``yadt_compact``."""
    if not (_STATE["enabled"] and _STATE["yadt_compact"]):
        return x
    return _constrain(x, (_dp_for(x.shape[0]), *([None] * (x.ndim - 1))))


def shard_kv_capture(x):
    """Prefill-captured KV (B, S, KV, hd): seq over TP under
    ``kv_seq_shard``."""
    if not (_STATE["enabled"] and _STATE["kv_seq_shard"]):
        return x
    return _constrain(x, (_dp_for(x.shape[0]), _tp_for(x.shape[1]),
                          None, None))


def shard_experts(x):
    """Pin (E, C, ...) expert-major tensors: E over TP, and with ``moe2d``
    the capacity axis over DP too."""
    if not _STATE["enabled"]:
        return x
    dims = [_tp_for(x.shape[0])] + [None] * (x.ndim - 1)
    if _STATE["moe2d"] and x.ndim >= 2:
        dims[1] = _dp_for(x.shape[1])
    return _constrain(x, tuple(dims))
