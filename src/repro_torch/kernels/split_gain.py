"""Wrapper of the CUDA fused split-gain kernel (``csrc/split_gain.cu``).

Replaces the JAX package's Pallas ``split_gain``: from the (K, A, B, C)
frontier histogram, ``score`` f32 (K, A) (-inf = no valid split) and
``split_bin`` int32 (K, A) (-1 for discrete attributes).  CUDA tensors only;
the plain version is :func:`repro_torch.kernels.ref.split_gain_ref`.  The
launch is the custom op ``torch.ops.repro_torch.split_gain``: a meta tensor
gets empty outputs and launches nothing, and under ``FlopCounterMode`` it
counts ``launch.roofline.split_gain_ops``.
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _dtensor, autotune
from repro_torch.launch import roofline

# Launches of the kernel in this process (the main path's proof of use).
LAUNCHES = 0
CRITERIA = ("gain", "gain_ratio")

# The kernel's shared-memory opt-in is a static of the C side.
_LIB = _build.Library(
    "split_gain", "split_gain_error", counts=__name__, opt_in=True,
    entries={"split_gain_launch": "p 2q 5p 4i f 6i"})


def split_gain(hist: torch.Tensor, total_w: torch.Tensor,
               attr_is_cont: torch.Tensor, n_bins: torch.Tensor, *,
               min_objs: float = 2.0, criterion: str = "gain",
               block_b: int | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(score, split_bin)`` per (slot, attribute) of ``hist`` f32
    (K, A, B, C), ``total_w`` f32 (K,), ``attr_is_cont`` bool (A,) and
    ``n_bins`` int32 (A,).

    ``hist`` may be a view whose last two axes are contiguous, such as the
    first B bins of the histogram kernel's (K, A, B+1, C) output.
    """
    dev = hist.device
    if dev.type not in ("cuda", "meta") and not _dtensor.is_dtensor(hist):
        raise ValueError(f"the CUDA split gain takes CUDA tensors, got {dev}")
    if criterion not in CRITERIA:
        raise ValueError(f"unknown criterion: {criterion!r}")
    if hist.ndim != 4 or hist.dtype != torch.float32:
        raise TypeError(f"hist must be f32 (K, A, B, C), got {hist.dtype} "
                        f"{tuple(hist.shape)}")
    k, a_dim, b_dim, c_dim = hist.shape
    if hist.stride(3) != 1 or hist.stride(2) != c_dim:
        raise ValueError("hist must have contiguous (B, C) rows")
    for t, name, dtype, shape in ((total_w, "total_w", torch.float32, (k,)),
                                  (attr_is_cont, "attr_is_cont", torch.bool,
                                   (a_dim,)),
                                  (n_bins, "n_bins", torch.int32, (a_dim,))):
        _build.check(t, name, dtype, shape, dev, dtype_error=ValueError)
    if k and a_dim and (b_dim == 0 or c_dim == 0):
        raise ValueError(f"hist needs B >= 1 and C >= 1, got {b_dim}, {c_dim}")
    return _op(hist, total_w, attr_is_cont, n_bins, float(min_objs),
               criterion, block_b)


@torch.library.custom_op("repro_torch::split_gain", mutates_args=(),
                         device_types="cuda")
def _op(hist: Tensor, total_w: Tensor, attr_is_cont: Tensor, n_bins: Tensor,
        min_objs: float, criterion: str, block_b: int | None
        ) -> tuple[Tensor, Tensor]:
    dev = hist.device
    k, a_dim, b_dim, c_dim = hist.shape
    score = torch.empty((k, a_dim), dtype=torch.float32, device=dev)
    split_bin = torch.empty((k, a_dim), dtype=torch.int32, device=dev)
    if k == 0 or a_dim == 0:
        return score, split_bin
    plan = autotune.plan_split_gain(n_bins=b_dim, n_classes=c_dim,
                                    block_b=block_b)
    _build.launch(
        _LIB, "split_gain_launch", dev, hist.data_ptr(), hist.stride(0),
        hist.stride(1), total_w.data_ptr(), attr_is_cont.data_ptr(),
        n_bins.data_ptr(), score.data_ptr(), split_bin.data_ptr(), k, a_dim,
        b_dim, c_dim, float(min_objs), int(criterion == "gain_ratio"),
        plan.warps, int(plan.regs), plan.seg, plan.seg_pad, plan.smem)
    return score, split_bin


@_op.register_fake
def _(hist, total_w, attr_is_cont, n_bins, min_objs, criterion, block_b):
    k, a_dim = hist.shape[:2]
    return (hist.new_empty((k, a_dim)),
            hist.new_empty((k, a_dim), dtype=torch.int32))


@register_flop_formula(torch.ops.repro_torch.split_gain)
def _flops(hist_shape, *args, **kw):
    return roofline.split_gain_ops(*hist_shape)


@_dtensor.register_sharding(torch.ops.repro_torch.split_gain.default)
def _sharding(hist, total_w, attr_is_cont, n_bins, min_objs, criterion,
              block_b):
    """Replicated, or over the slots K (the histogram's and the totals'
    first axis), or over the attributes A (the histogram's second axis,
    the flags and bin counts): each (slot, attribute) is scored alone."""
    rep, shard, _ = _dtensor.placements()
    rest = [None] * 3
    return [([rep, rep], [rep] * 4 + rest),
            ([shard(0), shard(0)], [shard(0), shard(0), rep, rep] + rest),
            ([shard(1), shard(1)], [shard(1), rep, shard(0), shard(0)]
             + rest)]


@_dtensor.register_cpu(_op)
def _(hist, total_w, attr_is_cont, n_bins, min_objs, criterion, block_b):
    from repro_torch.kernels import ref
    return ref.split_gain_ref(hist, total_w, attr_is_cont, n_bins,
                              min_objs=min_objs, criterion=criterion)
