"""Wrapper of the CUDA splitPost kernels (``csrc/split_post.cu``).

A superstep's splitPost in two launches on the current stream: the node
kernel (one block a slot: the node rows, the children, the statistics),
then the routing kernel (one pass over the cases).  No TPU kernel stands
behind it: the JAX package's splitPost is jnp under its jitted superstep.
CUDA tensors only; the plain version is the torch body of
:func:`repro_torch.core.frontier.split_post` (``impl="torch"``).

It updates the state in place, as the plain version updates the node
arrays: the node arrays, ``status``, ``active`` and ``case_node``.  The
new ``overflow``, the new open range ``(lo, n_nodes)`` and the
superstep's statistics are views of one small int32 tensor the node kernel
writes, so nothing is read back to the host and nothing waits.  Given
``ahead`` (a state whose open nodes are the id range ``[lo, n_nodes)``,
``core.frontier.OpenRange``), the routing kernel also writes the next
superstep's splitPre: ``ahead``'s K-wide planes, and ``pre["slot"]`` in
place, and the next superstep's live cases (next slot >= 0) into ``live``
as a list, counted beside the range.  The frontier engine's
``impl="cuda"`` build then waits for the card once a superstep, at the
loop's read of the range and the live count: its splitPre launches nothing
and reads nothing, and its splitAtt's histogram reads the live cases
through the list.  No custom op: only the frontier engine calls it, on a
state it owns.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build

# Launches of the two kernels in this process (the main path's proof of
# use: two a superstep).
LAUNCHES = 0

# The statistics' words in the node kernel's output, then the new lo,
# n_nodes and the next superstep's live cases (the open range's words).
STATS = ("n_processed", "n_active", "n_internal", "n_children", "max_r",
         "nap_nodes", "overflow")
COST_MODELS = ("alpha", "nlogn", "nsq")        # core.cost_models' order

_LIB = _build.Library(
    "split_post", "split_post_error", counts=__name__,
    entries={"split_post_nodes_launch": "7p 2q p 2q 20p 6i 2f",
             "split_post_route_launch": "6p q 2i 8p 2i f i"})
_INT32_MAX = 2 ** 31 - 1

# (name, dtype) of splitPre's K-wide planes
_PRE = (("ids", torch.int64), ("valid", torch.bool), ("ids_safe", torch.int64),
        ("total_w", torch.float32), ("depth_k", torch.int32),
        ("pre_leaf", torch.bool))
_NODES = (("node_attr", torch.int32), ("node_split_bin", torch.int32),
          ("node_child0", torch.int32), ("node_nchild", torch.int32),
          ("node_class", torch.int32), ("node_depth", torch.int32))


def split_post(tree, status: torch.Tensor, active: torch.Tensor,
               case_node: torch.Tensor, n_nodes: torch.Tensor,
               overflow: torch.Tensor, pre: dict, att: dict,
               x: torch.Tensor, attr_is_cont: torch.Tensor,
               n_bins: torch.Tensor, *, cost_model: str,
               n_total_cases: float, alpha: float, ahead: dict | None = None,
               lo: torch.Tensor | None = None, min_objs: float | None = None,
               max_depth: int | None = None, live: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """splitPost of one superstep on the card: ``tree``'s node arrays
    (M + 1 rows, row M the dump row), ``status``, ``active`` and
    ``case_node`` updated in place from splitPre's ``pre`` and splitAtt's
    ``att`` (the keys :func:`repro_torch.core.frontier.split_pre` and
    ``split_att`` return).  Returns the new open range and live count
    ``(lo, n_nodes, n_live)`` (int32 (3,); ``lo`` counts from ``lo``'s
    value, 0 without it; ``n_live`` 0 without ``ahead``), the new
    ``overflow`` and the statistics, the keys of :data:`STATS` (0-d int32
    views, ``max_r`` float32, ``overflow`` bool).

    ``cost_model``, ``n_total_cases`` and ``alpha`` are the NAP test's
    (:func:`repro_torch.core.cost_models.build_att_test`).

    ``ahead`` (splitPre's K-wide planes, the keys of ``_PRE``; ``pre``'s
    own may be given, since the routing kernel writes them after the node
    kernel has read them) has the routing kernel write the next
    superstep's splitPre for open nodes that are the id range ``[lo,
    n_nodes)`` (``lo`` 0-d int32): the planes into ``ahead``, each case's
    slot into ``pre["slot"]`` (-2 once its node is a leaf), with
    ``min_objs`` and ``max_depth`` the stop tests', and into ``live``
    (int32 (N,)) the indices of the cases whose next slot is >= 0,
    ``n_live`` of them in no fixed order."""
    if cost_model not in COST_MODELS:
        raise ValueError(f"unknown cost model {cost_model!r}; choose from "
                         f"{COST_MODELS}")
    if x.ndim != 2:
        raise ValueError(f"x must be (N, A), got shape {tuple(x.shape)}")
    n, a_dim = x.shape
    k = pre["ids"].shape[0]
    m1 = status.shape[0]
    hist, unknown = att["hist"], att["unknown"]
    if hist.ndim != 4 or hist.dtype != torch.float32:
        raise TypeError(f"hist must be f32 (K, A, B, C), got {hist.dtype} "
                        f"{tuple(hist.shape)}")
    b_dim, c_dim = hist.shape[2:]
    if tuple(hist.shape[:2]) != (k, a_dim):
        raise ValueError(f"hist has shape {tuple(hist.shape)}, expected "
                         f"({k}, {a_dim}, B, C)")
    if hist.stride(3) != 1 or hist.stride(2) != c_dim:
        raise ValueError("hist must have contiguous (B, C) rows")
    if unknown.dtype != torch.float32:
        raise TypeError(f"unknown must be torch.float32, got {unknown.dtype}")
    if tuple(unknown.shape) != (k, a_dim, c_dim) or unknown.stride(2) != 1:
        raise ValueError(f"unknown must be ({k}, {a_dim}, {c_dim}) with "
                         f"contiguous C, got {tuple(unknown.shape)}")
    if k < 1 or a_dim < 1 or b_dim < 1 or c_dim < 1 or m1 < 2:
        raise ValueError(f"empty splitPost: K {k}, A {a_dim}, B {b_dim}, "
                         f"C {c_dim}, M + 1 {m1}")
    for name, dtype in _PRE:
        _build.check(pre[name], name, dtype, (k,))
    _build.check(pre["slot"], "slot", torch.int32, (n,))
    for name, dtype, shape in (
            ("split_bin", torch.int32, (k, a_dim)),
            ("active_k", torch.bool, (k, a_dim)),
            ("best_attr", torch.int32, (k,)),
            ("has_split", torch.bool, (k,))):
        _build.check(att[name], name, dtype, shape)
    for name, dtype in _NODES:
        _build.check(getattr(tree, name), name, dtype, (m1,))
    _build.check(tree.node_freq, "node_freq", torch.float32, (m1, c_dim))
    _build.check(status, "status", torch.int32, (m1,))
    _build.check(active, "active", torch.bool, (m1, a_dim))
    _build.check(case_node, "case_node", torch.int32, (n,))
    _build.check(n_nodes, "n_nodes", torch.int32, ())
    _build.check(overflow, "overflow", torch.bool, ())
    nxt = []
    if lo is not None:
        _build.check(lo, "lo", torch.int32, ())
        nxt.append(lo)
    # the routing kernel's next frontier: its planes and stop tests
    planes, min_w, depth_cap = [None] * len(_PRE), 0.0, 0
    if ahead is not None:
        if lo is None or min_objs is None or max_depth is None or (
                live is None):
            raise ValueError("the next frontier needs lo, min_objs, "
                             "max_depth and live")
        for name, dtype in _PRE:
            _build.check(ahead[name], f"ahead {name}", dtype, (k,))
        nxt += [ahead[name] for name, _ in _PRE]
        planes = [ahead[name].data_ptr() for name, _ in _PRE]
        min_w, depth_cap = 2.0 * min_objs, min(max_depth, _INT32_MAX)
        if n > _INT32_MAX:
            raise ValueError(f"{n} cases: the live list's int32 indices "
                             "hold at most 2^31 - 1")
        _build.check(live, "live", torch.int32, (n,))
        nxt.append(live)
    elif live is not None:
        raise ValueError("the live list is the next frontier's: it needs "
                         "ahead")
    _build.check(x, "x", torch.int32, (n, a_dim))
    _build.check(attr_is_cont, "attr_is_cont", torch.bool, (a_dim,))
    _build.check(n_bins, "n_bins", torch.int32, (a_dim,))
    dev = x.device
    ins = [pre[name] for name, _ in _PRE] + [
        pre["slot"], hist, unknown, status, active, case_node, n_nodes,
        overflow, attr_is_cont, n_bins, tree.node_freq] + [
        att[name] for name in ("split_bin", "active_k", "best_attr",
                               "has_split")] + [
        getattr(tree, name) for name, _ in _NODES] + nxt
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError("the CUDA splitPost takes CUDA tensors on one "
                         f"device, got {sorted({str(t.device) for t in ins})}")

    route = torch.empty((k, 4), dtype=torch.int32, device=dev)
    words = torch.empty((len(STATS) + 3,), dtype=torch.int32, device=dev)
    _build.launch(
        _LIB, "split_post_nodes_launch", dev,
        *(pre[name].data_ptr() for name, _ in _PRE),
        hist.data_ptr(), hist.stride(0), hist.stride(1),
        unknown.data_ptr(), unknown.stride(0), unknown.stride(1),
        *(att[name].data_ptr() for name in ("split_bin", "active_k",
                                            "best_attr", "has_split")),
        attr_is_cont.data_ptr(), n_bins.data_ptr(),
        *(getattr(tree, name).data_ptr() for name in (
            "node_attr", "node_split_bin", "node_child0", "node_nchild",
            "node_class", "node_freq", "node_depth")),
        status.data_ptr(), active.data_ptr(), n_nodes.data_ptr(),
        overflow.data_ptr(), None if lo is None else lo.data_ptr(),
        route.data_ptr(), words.data_ptr(),
        k, a_dim, b_dim, c_dim, m1 - 1,
        COST_MODELS.index(cost_model), float(n_total_cases), float(alpha))
    _build.launch(
        _LIB, "split_post_route_launch", dev, pre["slot"].data_ptr(),
        x.data_ptr(), route.data_ptr(), case_node.data_ptr(),
        words.data_ptr(), None if live is None else live.data_ptr(), n,
        a_dim, k, *planes, tree.node_freq.data_ptr(),
        tree.node_depth.data_ptr(), c_dim, m1 - 1, min_w, depth_cap)
    w = words.unbind()
    stats = dict(zip(STATS, w))
    stats["max_r"] = w[STATS.index("max_r")].view(torch.float32)
    i = STATS.index("overflow")
    stats["overflow"] = words[i:i + 1].view(torch.bool)[0]
    return words[len(STATS):], stats["overflow"], stats
