"""Dispatch of the CUDA kernels by the tensors' device.

A CUDA tensor launches the hand-written kernel (or the launch raises); a CPU
tensor runs the plain version of :mod:`repro_torch.kernels.ref`.  There is
no fallback from one to the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import histogram, ref, tree_infer
from repro_torch.kernels import split_gain as _split_gain


def is_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises on another
    device."""
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
    if is_cuda(x):
        return histogram.frontier_histogram(
            x, y, w, slot, block_t=block_t, block_k=block_k, **kw)
    return ref.frontier_histogram_ref(x, y, w, slot, **kw)


def split_gain(hist, total_w, attr_is_cont, n_bins, *, min_objs: float = 2.0,
               criterion: str = "gain", block_b: int | None = None):
    """(score, split_bin) per (slot, attribute): CUDA kernel or plain."""
    kw = dict(min_objs=min_objs, criterion=criterion)
    if is_cuda(hist):
        return _split_gain.split_gain(hist, total_w, attr_is_cont, n_bins,
                                      block_b=block_b, **kw)
    return ref.split_gain_ref(hist, total_w, attr_is_cont, n_bins, **kw)


def forest_predict(node_tab, x_bins, attr_is_cont, *, max_depth: int,
                   block_n: int | None = None) -> torch.Tensor:
    """(T, N) leaf classes: CUDA traversal kernel or plain version."""
    if is_cuda(node_tab):
        return tree_infer.forest_predict(node_tab, x_bins, attr_is_cont,
                                         max_depth=max_depth, block_n=block_n)
    return ref.forest_predict_ref(node_tab, x_bins, attr_is_cont,
                                  max_depth=max_depth)


def flash_attention(q, k, v, *, window: int = 0, softcap: float = 0.0
                    ) -> torch.Tensor:
    """(B, Sq, H, D) causal GQA attention: CUDA kernel or plain version."""
    if is_cuda(q):
        return _flash.flash_attention(q, k, v, window=window, softcap=softcap)
    return ref.flash_attention_ref(q, k, v, window=window, softcap=softcap)
