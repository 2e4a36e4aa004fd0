"""Dispatch of the CUDA kernels by the tensors' device.

A CUDA tensor launches the hand-written kernel (or the launch raises); a CPU
tensor runs the plain version of :mod:`repro_torch.kernels.ref`.  There is
no fallback from one to the other.  A meta tensor takes the kernel's route
too: its wrapper returns empty outputs of the right shapes and counts the
kernel's work (the dry run's cost count), and no plain version runs.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import _dtensor, histogram, ref, tree_infer
from repro_torch.kernels import split_gain as _split_gain


def kernel_route(t: torch.Tensor) -> bool:
    """True for a CUDA or meta tensor or a DTensor (the kernel's wrapper:
    a DTensor's CPU shards reach the op's plain CPU kernel), False for a
    CPU tensor (the plain version); raises on another device."""
    if t.device.type in ("cuda", "meta") or _dtensor.is_dtensor(t):
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def frontier_histogram(x, y, w, slot, *, n_slots: int, n_bins: int,
                       n_classes: int, block_t: int | None = None,
                       block_k: int | None = None) -> torch.Tensor:
    """(K, A, B+1, C) weighted counts: CUDA kernel or plain version."""
    kw = dict(n_slots=n_slots, n_bins=n_bins, n_classes=n_classes)
    if kernel_route(x):
        return histogram.frontier_histogram(
            x, y, w, slot, block_t=block_t, block_k=block_k, **kw)
    return ref.frontier_histogram_ref(x, y, w, slot, **kw)


def split_gain(hist, total_w, attr_is_cont, n_bins, *, min_objs: float = 2.0,
               criterion: str = "gain", block_b: int | None = None):
    """(score, split_bin) per (slot, attribute): CUDA kernel or plain."""
    kw = dict(min_objs=min_objs, criterion=criterion)
    if kernel_route(hist):
        return _split_gain.split_gain(hist, total_w, attr_is_cont, n_bins,
                                      block_b=block_b, **kw)
    return ref.split_gain_ref(hist, total_w, attr_is_cont, n_bins, **kw)


def forest_predict(node_tab, x_bins, attr_is_cont, *, max_depth: int,
                   block_n: int | None = None) -> torch.Tensor:
    """(T, N) leaf classes: CUDA traversal kernel or plain version."""
    if kernel_route(node_tab):
        return tree_infer.forest_predict(node_tab, x_bins, attr_is_cont,
                                         max_depth=max_depth, block_n=block_n)
    return ref.forest_predict_ref(node_tab, x_bins, attr_is_cont,
                                  max_depth=max_depth)


def flash_attention(q, k, v, *, window: int = 0, softcap: float = 0.0
                    ) -> torch.Tensor:
    """(B, Sq, H, D) causal GQA attention: CUDA kernel or plain version."""
    if kernel_route(q):
        return _flash.flash_attention(q, k, v, window=window, softcap=softcap)
    return ref.flash_attention_ref(q, k, v, window=window, softcap=softcap)
