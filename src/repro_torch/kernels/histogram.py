"""Wrapper of the CUDA frontier-histogram kernel (``csrc/histogram.cu``).

Replaces the JAX package's Pallas ``frontier_histogram``: the same inputs
and the same ``(K, A, B+1, C)`` f32 output, with unknown bins (-1) counted
in bin B and cases of slot -1 dropped.  CUDA tensors only; the plain version
is :func:`repro_torch.kernels.ref.frontier_histogram_ref`.  Given a list of
cases (the live cases splitPost's routing kernel listed), the kernel reads
the listed rows of the inputs in place, as if they had been gathered.  The
launch is the custom op ``torch.ops.repro_torch.frontier_histogram``: a
meta tensor gets an empty output of the right shape and launches nothing,
and under ``FlopCounterMode`` it counts one add per (case, attribute)
(``launch.roofline.histogram_ops``).
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _dtensor, autotune
from repro_torch.launch import roofline

# Launches of the kernel in this process (the main path's proof of use).
LAUNCHES = 0
# Launches by plan ("direct", "shared"): which accumulation path ran.
PLANS = {"direct": 0, "shared": 0}
# Launches by where the cases came from: the rows themselves ("rows") or
# the rows a list of cases names ("list").
SOURCES = {"rows": 0, "list": 0}

# The kernel's shared-memory opt-in is a static of the C side.
_LIB = _build.Library(
    "histogram", "frontier_histogram_error", counts=__name__, by="PLANS",
    opt_in=True, entries={"frontier_histogram_launch": "6p q 11i"})


def frontier_histogram(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                       slot: torch.Tensor, *, n_slots: int, n_bins: int,
                       n_classes: int, n_live_slots: int | None = None,
                       block_t: int | None = None,
                       block_k: int | None = None,
                       case_list: torch.Tensor | None = None,
                       n_listed: int | None = None) -> torch.Tensor:
    """(K, A, B+1, C) weighted counts of ``x`` int32 (N, A) bins, ``y``
    int32 (N,) classes, ``w`` f32 (N,) weights, ``slot`` int32 (N,).

    ``case_list`` (int32, at least ``n_listed`` long) restricts the counts to
    the cases its first ``n_listed`` entries name, each at most once, in any
    order: the kernel reads those rows of ``x``, ``y``, ``w`` and ``slot``.

    ``n_live_slots`` says that the cases lie in slots below it (the open
    frontier's size): the planner sizes its shared window by it.  It is a
    hint, not a filter: a case of a higher slot is counted all the same.
    ``block_t`` / ``block_k`` pin the plan (see ``autotune.plan_histogram``).
    """
    dev = x.device
    if dev.type not in ("cuda", "meta") and not _dtensor.is_dtensor(x):
        raise ValueError(f"the CUDA histogram takes CUDA tensors, got {dev}")
    if x.ndim != 2:
        raise ValueError(f"x must be (N, A), got shape {tuple(x.shape)}")
    n, a_dim = x.shape
    _build.check(x, "x", torch.int32, (n, a_dim), dev)
    _build.check(y, "y", torch.int32, (n,), dev)
    _build.check(w, "w", torch.float32, (n,), dev)
    _build.check(slot, "slot", torch.int32, (n,), dev)
    if case_list is not None:
        if case_list.dtype != torch.int32 or case_list.ndim != 1:
            raise TypeError(f"case_list must be int32 (L,), got "
                            f"{case_list.dtype} {tuple(case_list.shape)}")
        if case_list.device != dev or not case_list.is_contiguous():
            raise ValueError("case_list must be contiguous, on the cases' "
                             "device")
        if n_listed is None or not 0 <= n_listed <= case_list.shape[0]:
            raise ValueError(f"n_listed {n_listed} outside the list's "
                             f"{case_list.shape[0]} entries")
    elif n_listed is not None:
        raise ValueError("n_listed without a case_list")
    return _op(x, y, w, slot, n_slots, n_bins, n_classes, n_live_slots,
               block_t, block_k, case_list, n_listed)


@torch.library.custom_op("repro_torch::frontier_histogram", mutates_args=(),
                         device_types="cuda")
def _op(x: Tensor, y: Tensor, w: Tensor, slot: Tensor, n_slots: int,
        n_bins: int, n_classes: int, n_live_slots: int | None,
        block_t: int | None, block_k: int | None, case_list: Tensor | None,
        n_listed: int | None) -> Tensor:
    dev = x.device
    a_dim = x.shape[1]
    n = x.shape[0] if case_list is None else n_listed
    out = torch.zeros((n_slots, a_dim, n_bins + 1, n_classes),
                      dtype=torch.float32, device=dev)
    if n == 0 or a_dim == 0 or n_slots == 0 or n_classes == 0:
        return out
    plan = autotune.plan_histogram(
        n_cases=n, n_slots=n_slots, n_bins=n_bins, n_classes=n_classes,
        n_attrs=a_dim, n_live_slots=n_live_slots, block_t=block_t,
        block_k=block_k)
    _build.launch(
        _LIB, "frontier_histogram_launch", dev, x.data_ptr(), y.data_ptr(),
        w.data_ptr(), slot.data_ptr(),
        None if case_list is None else case_list.data_ptr(), out.data_ptr(),
        n, a_dim, n_slots, plan.live, n_bins, n_classes, plan.block_k,
        plan.block_t, plan.blocks, plan.windows, plan.threads, plan.smem,
        label=plan.mode)
    _build.tally(SOURCES, "rows" if case_list is None else "list")
    return out


@_op.register_fake
def _(x, y, w, slot, n_slots, n_bins, n_classes, n_live_slots, block_t,
      block_k, case_list, n_listed):
    return x.new_empty((n_slots, x.shape[1], n_bins + 1, n_classes),
                       dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.frontier_histogram)
def _flops(x_shape, y, w, slot, n_slots, n_bins, n_classes, n_live_slots,
           block_t, block_k, case_list, n_listed, **kw):
    return roofline.histogram_ops(
        x_shape[0] if case_list is None else n_listed, x_shape[1])


@_dtensor.register_sharding(torch.ops.repro_torch.frontier_histogram.default)
def _sharding(x, y, w, slot, n_slots, n_bins, n_classes, n_live_slots,
              block_t, block_k, case_list, n_listed):
    """Replicated; the cases sharded, each shard's counts a partial sum
    (``sharding.act.shard_frontier_hist`` then reduce-scatters them over
    K, or they are summed where the histogram is read); or the attributes
    sharded (x's columns and the output's A axis).  No list: no
    partitioned caller has one."""
    rep, shard, partial = _dtensor.placements()
    rest = [None] * 8
    return [([rep], [rep] * 4 + rest),
            ([partial], [shard(0)] * 4 + rest),
            ([shard(1)], [shard(1)] + [rep] * 3 + rest)]


@_dtensor.register_cpu(_op)
def _(x, y, w, slot, n_slots, n_bins, n_classes, n_live_slots, block_t,
      block_k, case_list, n_listed):
    from repro_torch.kernels import ref
    return ref.frontier_histogram_ref(x, y, w, slot, n_slots=n_slots,
                                      n_bins=n_bins, n_classes=n_classes)
