"""Active-case compaction ahead of the frontier histogram.

Deep in the build the open frontier covers a small fraction of the training
set.  Gathering the live cases (slot >= 0) into dense buffers first makes
the histogram cost O(live) instead of O(N).  The JAX package needs a ladder
of static bucket sizes under ``lax.switch`` for this; here the gather is
sized by the live count itself (one ``nonzero``, which waits for the device)
and the histogram runs on exactly that many cases (a ``tracer`` times
that wait as a ``wait.compact`` span).  The buffers pass
through ``sharding.act.shard_active_cases`` as the JAX package's do (the
identity on a plain tensor).  The ``impl="cuda"`` build's states, which
keep the open range on the card, do not come here: splitPost's routing
kernel lists their live cases and the histogram kernel reads the rows
through that list (``core.frontier._histogram``), with no wait and no copy.

Of DTensor cases (a partitioned superstep), ``nonzero`` has no DTensor
strategy: each rank compacts its own shard, and the buffers are padded to
the largest rank's live count with dead cases (slot -1, weight 0, as the
JAX bucket pads) so that they shard evenly again.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._dtensor import is_dtensor
from repro_torch.obs.trace import NULL
from repro_torch.sharding.act import shard_active_cases


def live_cases(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               slot: torch.Tensor, tracer=NULL
               ) -> tuple[torch.Tensor, ...]:
    """``(x, y, w, slot)`` cut to the cases with ``slot >= 0``, in case
    order; the inputs themselves when every case is live.  Of DTensors,
    each rank's live cases in its shard, padded (:func:`_live_sharded`)."""
    if is_dtensor(slot):
        return _live_sharded(x, y, w, slot, tracer)
    with tracer.span("wait.compact"):
        idx = torch.nonzero(slot >= 0).flatten()
    if idx.numel() == slot.numel():
        return x, y, w, slot
    return (shard_active_cases(x.index_select(0, idx)),
            y.index_select(0, idx), w.index_select(0, idx),
            shard_active_cases(slot.index_select(0, idx)))


def _live_sharded(x, y, w, slot, tracer) -> tuple[torch.Tensor, ...]:
    """DTensor cases laid out alike: on each rank its shard's live cases
    in case order, then dead ones up to the mesh's largest live count (an
    all-reduce of one int over the mesh dims the cases are sharded on);
    the buffers keep the cases' layout, x and slot then pinned."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, pl = slot.device_mesh, slot.placements
    x, y, w, slot = (t.redistribute(mesh, pl).to_local()
                     for t in (x, y, w, slot))
    with tracer.span("wait.compact"):
        idx = torch.nonzero(slot >= 0).flatten()
    count = torch.tensor(idx.numel(), dtype=torch.int64, device=slot.device)
    most = int(DTensor.from_local(
        count, mesh, [Partial("max") if p.is_shard() else Replicate()
                      for p in pl], run_check=False).full_tensor())
    pad = most - idx.numel()

    def cut(t, fill):
        live = t.index_select(0, idx)
        dead = torch.full((pad, *t.shape[1:]), fill, dtype=t.dtype,
                          device=t.device)
        return DTensor.from_local(torch.cat([live, dead]), mesh, pl,
                                  run_check=False)
    return (shard_active_cases(cut(x, 0)), cut(y, 0), cut(w, 0),
            shard_active_cases(cut(slot, -1)))
