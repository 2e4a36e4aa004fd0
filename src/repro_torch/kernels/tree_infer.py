"""Wrapper of the CUDA forest-traversal kernel (``csrc/tree_infer.cu``).

Replaces the JAX package's Pallas ``forest_predict``: the same packed
``(T, M, NODE_COLS)`` node table, ``(N, A)`` binned cases (-1 unknown) and
``(A,)`` continuous flags in, the ``(T, N)`` int32 leaf classes out.  CUDA
tensors only; the plain version is
:func:`repro_torch.kernels.ref.forest_predict_ref`.  The launch is the custom
op ``torch.ops.repro_torch.forest_predict``: a meta tensor gets an empty
output and launches nothing, and under ``FlopCounterMode`` it counts
``launch.roofline.traversal_ops`` of every walk descending ``max_depth``
levels (at most what the data takes: a meta tensor holds none).
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _dtensor, autotune
from repro_torch.launch import roofline

#: Column layout of the packed node table (see ``Forest.node_table``).
COL_ATTR, COL_SPLIT, COL_CHILD0, COL_NCHILD, COL_HEAVY, COL_CLASS = range(6)
NODE_COLS = 8          # 6 live columns padded to 8: two int4 loads a row

# Launches of the kernel in this process (the main path's proof of use),
# and by plan ("wide": 1,024-case blocks, "spread": smaller blocks that put
# a small batch on every SM).
LAUNCHES = 0
PLANS = {"wide": 0, "spread": 0}

_LIB = _build.Library(
    "tree_infer", "forest_predict_error", counts=__name__, by="PLANS",
    entries={"forest_predict_launch": "4p q i q 4i"})


def forest_predict(node_tab: torch.Tensor, x_bins: torch.Tensor,
                   attr_is_cont: torch.Tensor, *, max_depth: int,
                   block_n: int | None = None) -> torch.Tensor:
    """(T, N) int32 leaf classes of ``node_tab`` int32 (T, M, NODE_COLS),
    ``x_bins`` int32 (N, A) and ``attr_is_cont`` bool (A,), descending at
    most ``max_depth`` levels (a host integer: the forest's ``n_levels``).

    ``block_n`` pins the cases (threads) a block (None: the autotune plan).
    """
    dev = node_tab.device
    if dev.type not in ("cuda", "meta") and not _dtensor.is_dtensor(x_bins):
        raise ValueError(f"the CUDA forest traversal takes CUDA tensors, "
                         f"got {dev}")
    if node_tab.ndim != 3 or node_tab.shape[-1] != NODE_COLS:
        raise ValueError(f"node_tab must be (T, M, {NODE_COLS}), got shape "
                         f"{tuple(node_tab.shape)}")
    if x_bins.ndim != 2:
        raise ValueError(f"x_bins must be (N, A), got shape "
                         f"{tuple(x_bins.shape)}")
    t_dim, m_dim, _ = node_tab.shape
    n, a_dim = x_bins.shape
    for t, name, dtype, shape in (
            (node_tab, "node_tab", torch.int32, (t_dim, m_dim, NODE_COLS)),
            (x_bins, "x_bins", torch.int32, (n, a_dim)),
            (attr_is_cont, "attr_is_cont", torch.bool, (a_dim,))):
        _build.check(t, name, dtype, shape, dev, dtype_error=ValueError)
    if max_depth < 0:
        raise ValueError(f"max_depth must be >= 0, got {max_depth}")
    if n and t_dim and m_dim == 0:
        raise ValueError("node_tab needs M >= 1 (the root)")
    return _op(node_tab, x_bins, attr_is_cont, int(max_depth), block_n)


@torch.library.custom_op("repro_torch::forest_predict", mutates_args=(),
                         device_types="cuda")
def _op(node_tab: Tensor, x_bins: Tensor, attr_is_cont: Tensor,
        max_depth: int, block_n: int | None) -> Tensor:
    dev = node_tab.device
    t_dim, m_dim, _ = node_tab.shape
    n, a_dim = x_bins.shape
    out = torch.empty((t_dim, n), dtype=torch.int32, device=dev)
    if n == 0 or t_dim == 0:
        return out
    plan = autotune.plan_infer_blocks(n_cases=n, n_trees=t_dim,
                                      block_n=block_n)
    _build.launch(
        _LIB, "forest_predict_launch", dev, node_tab.data_ptr(),
        x_bins.data_ptr(), attr_is_cont.data_ptr(), out.data_ptr(), n, a_dim,
        t_dim, m_dim, int(max_depth), plan.threads, plan.tree_blocks,
        label=plan.mode)
    return out


@_op.register_fake
def _(node_tab, x_bins, attr_is_cont, max_depth, block_n):
    return x_bins.new_empty((node_tab.shape[0], x_bins.shape[0]))


@register_flop_formula(torch.ops.repro_torch.forest_predict)
def _flops(tab_shape, x_shape, cont_shape, max_depth, *args, **kw):
    return roofline.traversal_ops(tab_shape[0] * x_shape[0] * max_depth)


@_dtensor.register_sharding(torch.ops.repro_torch.forest_predict.default)
def _sharding(node_tab, x_bins, attr_is_cont, max_depth, block_n):
    """Replicated; the cases sharded (the output's N axis); or the trees
    sharded (the table's T axis and the output's)."""
    rep, shard, _ = _dtensor.placements()
    rest = [None, None]
    return [([rep], [rep] * 3 + rest),
            ([shard(1)], [rep, shard(0), rep] + rest),
            ([shard(0)], [shard(0), rep, rep] + rest)]


@_dtensor.register_cpu(_op)
def _(node_tab, x_bins, attr_is_cont, max_depth, block_n):
    from repro_torch.kernels import ref
    return ref.forest_predict_ref(node_tab, x_bins, attr_is_cont,
                                  max_depth=max_depth)
