"""Dispatch of the splitAtt kernels by the tensors' device.

A CUDA tensor launches the hand-written kernel (or the launch raises); a CPU
tensor runs the plain version of :mod:`repro_torch.kernels.ref`.  There is
no fallback from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import histogram, ref
from repro_torch.kernels import split_gain as _split_gain


def _is_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def frontier_histogram(x, y, w, slot, *, n_slots: int, n_bins: int,
                       n_classes: int, block_t: int | None = None,
                       block_k: int | None = None) -> torch.Tensor:
    """(K, A, B+1, C) weighted counts: CUDA kernel or plain version."""
    kw = dict(n_slots=n_slots, n_bins=n_bins, n_classes=n_classes)
    if _is_cuda(x):
        return histogram.frontier_histogram(
            x, y, w, slot, block_t=block_t, block_k=block_k, **kw)
    return ref.frontier_histogram_ref(x, y, w, slot, **kw)


def split_gain(hist, total_w, attr_is_cont, n_bins, *, min_objs: float = 2.0,
               criterion: str = "gain", block_b: int | None = None):
    """(score, split_bin) per (slot, attribute): CUDA kernel or plain."""
    kw = dict(min_objs=min_objs, criterion=criterion)
    if _is_cuda(hist):
        return _split_gain.split_gain(hist, total_w, attr_is_cont, n_bins,
                                      block_b=block_b, **kw)
    return ref.split_gain_ref(hist, total_w, attr_is_cont, n_bins, **kw)
