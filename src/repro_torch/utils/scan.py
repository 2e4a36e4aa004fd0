"""The scan of the port's chunk loops: the counterpart of ``repro.utils.scan``.

The JAX package routes every model-internal loop through its ``scan``
because ``compiled.cost_analysis()`` counts a ``lax.scan`` body once; under
``unrolled()`` (its dry run's analysis) the scan becomes a Python loop, and
``analysis_chunk`` lets memory-motivated chunk sizes grow so that the
unrolled graph stays small.

Eager PyTorch runs every iteration as its own ops, so every count sees
every iteration already: :func:`scan` is always a Python loop over the
leading axis of ``xs``, stacking the per-step outputs as ``jax.lax.scan``
does, and :func:`unrolled` changes only :func:`analysis_chunk`.  The port
routes the loops the JAX package scans through it: the chunked
cross-entropy (``models/model.py``) and RWKV's chunk loop
(``models/rwkv6.py``).  The third user in the JAX package, the chunk sizes
of its blockwise flash attention (``repro/models/layers.py:384-385``), has
no counterpart: the port's attention is one kernel launch with no chunk
sizes (``repro_torch.models.layers.blockwise_attention``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

_STATE = {"unroll": False}
# The active cost counters (``launch.roofline.count_costs`` pushes one):
# each has ``repeat(n)``, a context in which it counts every op n times.
COUNTERS: list = []


@contextlib.contextmanager
def unrolled():
    old = _STATE["unroll"]
    _STATE["unroll"] = True
    try:
        yield
    finally:
        _STATE["unroll"] = old


def is_unrolled() -> bool:
    return _STATE["unroll"]


def analysis_chunk(prod_chunk: int, total: int, max_blocks: int = 8) -> int:
    """Chunk size to use: production value, or total/max_blocks when
    unrolled (keeps the unrolled block count bounded)."""
    if not _STATE["unroll"]:
        return prod_chunk
    return max(prod_chunk, -(-total // max_blocks))


def counting_meta(tree: Any) -> bool:
    """True when a cost counter is active and every tensor of ``tree`` is
    a meta tensor: iterations of identical shapes may run once, inside
    :func:`counted`."""
    leaves = [t for t in pytree.tree_leaves(tree)
              if isinstance(t, torch.Tensor)]
    return bool(COUNTERS) and bool(leaves) and all(t.is_meta for t in leaves)


@contextlib.contextmanager
def counted(n: int):
    """Every active counter counts what runs inside ``n`` times."""
    with contextlib.ExitStack() as stack:
        for c in COUNTERS:
            stack.enter_context(c.repeat(n))
        yield


def scan(f: Callable, init: Any, xs: Any, length: int | None = None):
    """``jax.lax.scan`` on tensors and pytrees of them (no reverse/unroll):
    ``f(carry, x) -> (carry, y)`` over the leading axis of every leaf of
    ``xs`` (``xs=None`` with ``length``: ``f(carry, None)`` that many
    times); returns the last carry and the ``y`` leaves stacked, or None
    when every ``y`` is None."""
    if xs is None:
        n = length
        slices = [None] * n
    else:
        leaves = pytree.tree_leaves(xs)
        n = length or leaves[0].shape[0]
        slices = [pytree.tree_map(lambda a, i=i: a[i], xs) for i in range(n)]
    carry = init
    ys = []
    if n > 1 and not torch.is_grad_enabled() and counting_meta((init, xs)):
        with counted(n):
            carry, y = f(carry, slices[0])
        ys = [y] * n
    for xi in slices[len(ys):]:
        carry, y = f(carry, xi)
        ys.append(y)
    if all(y is None for y in ys):
        return carry, None
    flat = [pytree.tree_flatten(y) for y in ys]
    spec = flat[0][1]
    stacked = [torch.stack(leaves) for leaves in zip(*(fl[0] for fl in flat))]
    return carry, pytree.tree_unflatten(stacked, spec)
