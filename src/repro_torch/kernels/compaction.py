"""Active-case compaction ahead of the frontier histogram.

Deep in the build the open frontier covers a small fraction of the training
set.  Gathering the live cases (slot >= 0) into dense buffers first makes
the histogram cost O(live) instead of O(N).  The JAX package needs a ladder
of static bucket sizes under ``lax.switch`` for this; here the gather is
sized by the live count itself (one ``nonzero``, which waits for the device)
and the histogram runs on exactly that many cases.
"""

from __future__ import annotations

import torch


def live_cases(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
               slot: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``(x, y, w, slot)`` cut to the cases with ``slot >= 0``, in case
    order; the inputs themselves when every case is live."""
    idx = torch.nonzero(slot >= 0).flatten()
    if idx.numel() == slot.numel():
        return x, y, w, slot
    return (x.index_select(0, idx), y.index_select(0, idx),
            w.index_select(0, idx), slot.index_select(0, idx))
