"""Level-synchronous frontier tree growth on torch tensors.

The torch counterpart of the JAX package's frontier engine.  The farm's task
stream is a frontier of open nodes, drained K = ``GrowConfig.frontier_slots``
at a time per superstep:

  splitPre   -> frontier selection and batched stop tests
  splitAtt   -> the (node, attr, bin, class) histogram and the gain pass
  splitPost  -> argmax, child allocation and case re-routing

Open nodes are taken in ascending id order and children are allocated
contiguously in slot order, so node ids are the sequential oracle's
breadth-first ids and trees compare elementwise with it.  Since only
children are opened, the open nodes are always one range of ids,
``[lo, n_nodes)``, drained from the front.

``impl="cuda"`` runs splitAtt on the hand-written CUDA kernels (histogram,
then the fused split gain) and splitPost on two more (the node results and
children, then the cases' routing: ``kernels.split_post``); ``impl="torch"``
runs their plain versions.  With ``GrowConfig.compact`` set, the histogram
counts the live cases alone: the ``cuda`` build's reads them through the
list splitPost's routing kernel wrote (below), the others gather them
first (``kernels.compaction``).  Per-node state arrays carry one extra
dump row (index M) that absorbs the writes of unused slots, in place of
the JAX scatters' ``mode="drop"``; readers only look at rows below M.

The ``cuda`` build keeps the open range on the card (:class:`OpenRange`):
splitPost's kernels also write the next superstep's splitPre, so its
splitPre launches nothing and reads nothing, and the next superstep's live
cases as a list, counted beside the range, so its splitAtt neither gathers
nor waits; the loop's test is one read of the range's two words and the
live count.  A state without the range (the ``torch`` build, a partitioned
superstep, a state made by hand) takes the plain splitPre, which selects
the frontier from ``status``, and the compaction's gather.

A superstep also runs partitioned, on DTensors (``launch.specs``' yadt
cell: the cases sharded over the mesh, the node arrays replicated).
splitPre and splitPost run on each rank's local tensors, as GSPMD
replicates what it cannot partition (``nonzero``, the node scatters):
every rank the same node arithmetic on its whole copy of the node arrays,
and the case lookups and routing on its own cases (:func:`_local_state`).
In splitAtt the compaction runs on the rank's own cases
(``kernels.compaction.live_cases``) and the histogram kernel's op counts
them under its registered sharding strategy, a partial sum across ranks
(``sharding.act.shard_frontier_hist`` reduce-scatters it over K under the
``yadt_rs`` knob, as the JAX package's does).

With an enabled ``Tracer`` (``build(tracer=...)``) the build runs as
spans on the host's clock that add no wait for the card: ``entry.copy``
(the rows to the device), ``entry.init`` (the initial state and the
loop's first test), then a ``superstep`` span a superstep holding its
``splitPre`` / ``splitAtt`` / ``splitPost`` phases and the loop's next
test.  Each place the host waits for the card is a ``wait.*`` span around
the read itself: ``wait.loop`` (the loop's test), ``wait.frontier`` (the
plain splitPre's ``nonzero``), ``wait.compact`` (the compaction's
``nonzero``, inside splitAtt's ``compact`` span, which holds the whole
gather of the live cases; on the ``cuda`` build ``compact`` holds only
the handoff of the list and no wait), ``wait.status`` (the root's status,
written from a host scalar in the initial state, which torch copies to the
device and waits for; the plain splitPost writes the new children's so
too, the CUDA splitPost in its node kernel, ``kernels.split_post``) and
``wait.stats`` (the one read of every superstep's statistics, after the
loop).  The ``cuda`` build so waits once a superstep (``wait.loop``), the
``torch`` build four times.  ``kernel.histogram`` and ``kernel.split_gain``
time the host's calls of splitAtt's two kernels, ``kernel.split_post``
those of splitPost's two.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import cost_models, entropy
from repro_torch.core.binning import BinnedDataset
from repro_torch.core.config import GrowConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import Tree
from repro_torch.kernels import compaction, histogram, ref, split_gain
from repro_torch.kernels import split_post as post_kernels
from repro_torch.kernels._dtensor import is_dtensor
from repro_torch.obs.trace import NULL
from repro_torch.sharding.act import (active_cases_sharded, replicate,
                                      shard_frontier_hist)

EPS_W = entropy.EPS_W
IMPLS = ("cuda", "torch")


@dataclasses.dataclass
class OpenRange:
    """The open nodes as the id range ``[lo, n_nodes)`` on the card, and
    the coming superstep's splitPre, which splitPost's kernels write: the
    frontier is ``lo + arange(n_open)``, ``n_open = min(K, n_nodes - lo)``,
    and a case's slot is its node less ``lo`` inside it.  The cases of slot
    >= 0 (live), ``n_live`` of them, are listed in ``live``."""
    # int32 (3,): lo, n_nodes (the state's a view), n_live
    bounds: torch.Tensor
    # splitPre's outputs, which splitPost's kernels rewrite in place: the
    # K-wide planes, slot (int32 (N,): -1 an open node outside the
    # frontier, -2 a leaf) and n_open (host int, None until the range is
    # read)
    pre: dict[str, Any]
    # int32 (N,), one buffer a build: its first n_live entries the live
    # cases in no fixed order, which the routing kernel rewrites in place;
    # not listed at the root, whose cases are all live
    live: torch.Tensor
    listed: bool = False
    n_live: int | None = None  # read with the range by the loop's test


@dataclasses.dataclass
class GrowState:
    tree: Tree                 # arrays of M+1 rows (row M = dump row)
    status: torch.Tensor       # int32 (M+1,): 0 empty 1 open 2 internal 3 leaf
    active: torch.Tensor       # bool (M+1, A): attributes active at each node
    case_node: torch.Tensor    # int32 (N,): current node of each case
    n_nodes: torch.Tensor      # int32 0-d
    overflow: torch.Tensor     # bool 0-d: capacity forced early leaves
    open_range: OpenRange | None = None     # impl="cuda" builds only

    STATUS_EMPTY = 0
    STATUS_OPEN = 1
    STATUS_INTERNAL = 2
    STATUS_LEAF = 3


@dataclasses.dataclass(frozen=True)
class FrontierProblem:
    """Static description of one growth problem."""
    n_cases: int
    n_attrs: int
    n_bins_max: int          # B: histogram bins (padded)
    n_classes: int
    max_children: int        # H: >= 2 and >= widest discrete split
    cfg: GrowConfig

    @staticmethod
    def from_dataset(ds: BinnedDataset, cfg: GrowConfig) -> "FrontierProblem":
        disc = ds.n_bins[~ds.attr_is_cont]
        h = max(2, int(disc.max()) if disc.size else 2)
        return FrontierProblem(
            n_cases=ds.n_cases, n_attrs=ds.n_attrs,
            n_bins_max=max(1, ds.max_bins), n_classes=ds.n_classes,
            max_children=h, cfg=cfg)


def init_state(prob: FrontierProblem, y: torch.Tensor, w: torch.Tensor,
               attr_mask: torch.Tensor | None = None, tracer=NULL, *,
               open_range: bool = False) -> GrowState:
    """The root alone, open.  ``open_range`` keeps the open nodes as an
    :class:`OpenRange` with the root's frontier (``impl="cuda"`` builds,
    whose splitPost's kernels carry it on)."""
    cfg = prob.cfg
    dev = y.device
    m = cfg.max_nodes
    tree = Tree.empty(m + 1, prob.n_classes, dev)
    root_freq = torch.zeros((prob.n_classes,), dtype=torch.float32,
                            device=dev).index_add_(0, y.long(), w)
    tree.node_freq[0] = root_freq
    tree.node_class[0] = torch.argmax(root_freq).to(torch.int32)
    active = torch.ones((m + 1, prob.n_attrs), dtype=torch.bool, device=dev)
    if attr_mask is not None:
        active &= attr_mask[None, :]
    status = torch.zeros((m + 1,), dtype=torch.int32, device=dev)
    # a host scalar written by index goes through a blocking copy to the
    # device, so the host waits here for the root's counts
    with tracer.span("wait.status"):
        status[0] = GrowState.STATUS_OPEN
    state = GrowState(
        tree=tree, status=status, active=active,
        case_node=torch.zeros((prob.n_cases,), dtype=torch.int32, device=dev),
        n_nodes=torch.ones((), dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev))
    if open_range:
        # (lo, n_nodes, n_live) = (0, 1, N), made on the card: no host
        # value to copy
        bounds = torch.arange(3, dtype=torch.int32, device=dev)
        bounds[2:].fill_(prob.n_cases)
        j = torch.arange(cfg.frontier_slots, device=dev)
        pre = _stop_tests(tree, torch.where(j == 0, 0, m), cfg)
        state.n_nodes = bounds[1]
        state.open_range = OpenRange(
            bounds=bounds,
            pre=dict(pre, slot=torch.zeros_like(state.case_node),
                     n_open=None),
            live=torch.empty_like(state.case_node))
    return state


# --------------------------------------------------------------------------
# splitAtt's two kernels
# --------------------------------------------------------------------------

def _whole(t):
    """A node-side DTensor's whole value on this rank (replicated first);
    anything else as it is."""
    return replicate(t).to_local() if is_dtensor(t) else t


def _own(t, cases):
    """A case-side DTensor's rows on this rank, laid out as ``cases``."""
    return t.redistribute(cases.device_mesh, cases.placements).to_local()


def _as_replicated(t, cases):
    """``t``, the same on every rank, as a replicated DTensor on the
    cases' mesh; a non-tensor as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = cases.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _as_cases(t, cases):
    """This rank's rows ``t`` of a (N, ...) case array, laid out as
    ``cases``."""
    from torch.distributed.tensor import DTensor
    shape = (cases.shape[0], *t.shape[1:])
    return DTensor.from_local(t, cases.device_mesh, cases.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _local_state(state: GrowState) -> GrowState:
    """A partitioned state on this rank: the node arrays whole, the cases'
    nodes its own rows."""
    tree = dataclasses.replace(state.tree, **{
        f.name: _whole(getattr(state.tree, f.name))
        for f in dataclasses.fields(Tree)})
    return GrowState(tree=tree, status=_whole(state.status),
                     active=_whole(state.active),
                     case_node=_own(state.case_node, state.case_node),
                     n_nodes=_whole(state.n_nodes),
                     overflow=_whole(state.overflow))


def _laid_state(local: GrowState, cases) -> GrowState:
    """:func:`_local_state`'s inverse, laid out as ``cases``."""
    tree = dataclasses.replace(local.tree, **{
        f.name: _as_replicated(getattr(local.tree, f.name), cases)
        for f in dataclasses.fields(Tree)})
    return GrowState(tree=tree, status=_as_replicated(local.status, cases),
                     active=_as_replicated(local.active, cases),
                     case_node=_as_cases(local.case_node, cases),
                     n_nodes=_as_replicated(local.n_nodes, cases),
                     overflow=_as_replicated(local.overflow, cases))


def _histogram(x, y, w, slot, *, n_open: int, prob: FrontierProblem,
               impl: str, tracer=NULL, rng: OpenRange | None = None):
    """The (K, A, B+1, C) histogram; the cases lie in slots below
    ``n_open``, which sizes the kernel's shared window.  Compacted, the
    ``cuda`` path's open range ``rng`` hands the kernel its list of the
    live cases (none at the root, where every case is live); other states
    gather the live cases (``compaction.live_cases``).  Of DTensor cases,
    the kernel's op (on CPU shards its CPU kernel, the plain version)
    counts each rank's cases, a partial sum over the mesh dims the cases
    are sharded on; without the ``yadt_compact`` knob every rank takes all
    the cases (gathered) and the histogram is replicated."""
    cfg = prob.cfg
    kw = dict(n_slots=cfg.frontier_slots, n_bins=prob.n_bins_max,
              n_classes=prob.n_classes)
    if is_dtensor(x) and not active_cases_sharded():
        x, y, w, slot = (replicate(t) for t in (x, y, w, slot))
    listed = {}
    if cfg.compact and impl == "cuda" and rng is not None:
        with tracer.span("compact"):
            if rng.listed:
                listed = dict(case_list=rng.live, n_listed=rng.n_live)
    elif cfg.compact:
        with tracer.span("compact"):
            x, y, w, slot = compaction.live_cases(x, y, w, slot,
                                                  tracer=tracer)
    with tracer.span("kernel.histogram"):
        if impl == "torch" and not is_dtensor(x):
            return ref.frontier_histogram_ref(x, y, w, slot, **kw)
        return histogram.frontier_histogram(
            x, y, w, slot, n_live_slots=n_open, block_t=cfg.block_t,
            block_k=cfg.block_k, **listed, **kw)


def _gains(hist, total_w, attr_is_cont, n_bins, *, prob: FrontierProblem,
           impl: str, tracer=NULL):
    """(K, A) score / split-bin planes from the (K, A, B, C) histogram."""
    cfg = prob.cfg
    kw = dict(min_objs=cfg.min_objs, criterion=cfg.criterion)
    with tracer.span("kernel.split_gain"):
        if impl == "torch":
            return ref.split_gain_ref(hist, total_w, attr_is_cont, n_bins,
                                      **kw)
        return split_gain.split_gain(hist, total_w, attr_is_cont, n_bins,
                                     block_b=cfg.block_b, **kw)


# --------------------------------------------------------------------------
# One superstep = splitPre + splitAtt + splitPost over K open nodes.
# --------------------------------------------------------------------------

def _stop_tests(tree: Tree, ids: torch.Tensor, cfg: GrowConfig
                ) -> dict[str, torch.Tensor]:
    """The K-wide planes of the frontier ``ids`` (padded with M): the
    stop tests on stored node frequencies."""
    m = cfg.max_nodes
    valid = ids < m
    ids_safe = torch.clamp_max(ids, m - 1)
    freq = torch.where(valid[:, None], tree.node_freq[ids_safe], 0.0)
    total_w = torch.sum(freq, dim=-1)
    depth_k = tree.node_depth[ids_safe]
    pure = torch.sum((freq > EPS_W).to(torch.int32), -1) <= 1
    small = total_w < 2.0 * cfg.min_objs
    deep = depth_k >= cfg.max_depth
    return dict(ids=ids, valid=valid, ids_safe=ids_safe, total_w=total_w,
                depth_k=depth_k, pre_leaf=pure | small | deep)


def split_pre(state: GrowState, *, prob: FrontierProblem, tracer=NULL
              ) -> dict[str, torch.Tensor]:
    """Frontier selection + stop tests on stored node frequencies.  Of a
    state with the open range, the planes splitPost's kernels wrote, with
    no launch and no wait: the loop's test must have read the range
    (``_open_left``).  Of a partitioned state, on each rank's local
    tensors (the module's docstring); ``slot`` then takes the cases'
    layout."""
    if state.open_range is not None:
        if state.open_range.pre["n_open"] is None:
            raise RuntimeError("split_pre of an open range the loop's test "
                               "has not read")
        return state.open_range.pre
    if is_dtensor(state.case_node):
        cases = state.case_node
        pre = split_pre(_local_state(state), prob=prob, tracer=tracer)
        return {k: _as_cases(v, cases) if k == "slot"
                else _as_replicated(v, cases) for k, v in pre.items()}
    cfg = prob.cfg
    m, k = cfg.max_nodes, cfg.frontier_slots
    dev = state.status.device

    # ---- the first K open node ids, ascending (= breadth-first), padded
    # with m: nonzero returns them sorted
    with tracer.span("wait.frontier"):
        ids = torch.nonzero(state.status[:m] == GrowState.STATUS_OPEN
                            ).flatten()[:k]
        n_open = ids.numel()         # host-side: nonzero has synchronised
    ids = torch.nn.functional.pad(ids, (0, k - n_open), value=m)

    node_to_slot = torch.full((m + 1,), -1, dtype=torch.int32, device=dev)
    node_to_slot[ids] = torch.arange(k, dtype=torch.int32, device=dev)
    slot = node_to_slot[state.case_node.long()]                   # (N,)
    return dict(_stop_tests(state.tree, ids, cfg), n_open=n_open, slot=slot)


def split_att(state: GrowState, pre: dict, x: torch.Tensor, y: torch.Tensor,
              w: torch.Tensor, attr_is_cont: torch.Tensor,
              n_bins: torch.Tensor, *, prob: FrontierProblem, impl: str,
              tracer=NULL) -> dict[str, torch.Tensor]:
    """The hot phase: histogram + gain over (node, attribute)."""
    b_dim = prob.n_bins_max
    hist_u = shard_frontier_hist(_histogram(
        x, y, w, pre["slot"], n_open=pre["n_open"], prob=prob, impl=impl,
        tracer=tracer, rng=state.open_range))
    hist = hist_u[:, :, :b_dim, :]
    unknown = hist_u[:, :, b_dim, :]                              # (K, A, C)
    score, split_bin = _gains(hist, pre["total_w"], attr_is_cont, n_bins,
                              prob=prob, impl=impl, tracer=tracer)
    # the K-wide planes whole on every rank, as the node arithmetic below
    # and splitPost read them
    score, split_bin = replicate(score), replicate(split_bin)
    active_k = state.active[pre["ids_safe"]] & pre["valid"][:, None]
    best_attr, _, has_split = entropy.pick_best_attribute(score, active_k)
    return dict(hist=hist, unknown=unknown, split_bin=split_bin,
                active_k=active_k, best_attr=best_attr, has_split=has_split)


def split_post(state: GrowState, pre: dict, att: dict, x: torch.Tensor,
               attr_is_cont: torch.Tensor, n_bins: torch.Tensor, *,
               prob: FrontierProblem, impl: str = "torch", tracer=NULL
               ) -> tuple[GrowState, dict[str, torch.Tensor]]:
    """Argmax done: allocate children, scatter results, route cases.
    ``impl="cuda"`` runs the two CUDA kernels (:func:`_split_post_cuda`),
    ``impl="torch"`` the plain version below.  Of a partitioned state, on
    each rank's local tensors (the module's docstring; CPU shards take the
    plain version, as the kernel ops' CPU shards do); ``n_active`` is then
    a partial count."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if is_dtensor(state.case_node):
        from torch.distributed.tensor import DTensor, Partial, Replicate
        cases = state.case_node
        x_own = _own(x, cases)
        local, stats = split_post(
            _local_state(state),
            {k: _own(v, cases) if k == "slot" else _whole(v)
             for k, v in pre.items()},
            {k: _whole(v) for k, v in att.items()}, x_own,
            _whole(attr_is_cont), _whole(n_bins), prob=prob,
            impl=impl if x_own.is_cuda else "torch", tracer=tracer)
        stats = {k: _as_replicated(v, cases) for k, v in stats.items()}
        stats["n_active"] = DTensor.from_local(
            stats["n_active"].to_local(), cases.device_mesh,
            [Partial() if p.is_shard() else Replicate()
             for p in cases.placements], run_check=False)
        return _laid_state(local, cases), stats
    if impl == "cuda":
        return _split_post_cuda(state, pre, att, x, attr_is_cont, n_bins,
                                prob=prob, tracer=tracer)
    cfg = prob.cfg
    m, k = cfg.max_nodes, cfg.frontier_slots
    a_dim, c_dim, h_dim = prob.n_attrs, prob.n_classes, prob.max_children
    dev = x.device
    tree = state.tree
    ids, valid, ids_safe = pre["ids"], pre["valid"], pre["ids_safe"]
    slot, total_w, depth_k = pre["slot"], pre["total_w"], pre["depth_k"]
    hist, unknown, active_k = att["hist"], att["unknown"], att["active_k"]
    best_attr = att["best_attr"].long()
    rows = torch.arange(k, device=dev)

    internal = valid & ~pre["pre_leaf"] & att["has_split"]
    is_cont = attr_is_cont[best_attr]
    sb = att["split_bin"][rows, best_attr]
    nch_attr = torch.where(is_cont, 2, n_bins[best_attr]).to(torch.int32)
    nch = torch.where(internal, nch_attr, 0).to(torch.int32)

    # capacity check: if this superstep would overflow, force leaves instead
    overflow = state.n_nodes + torch.sum(nch) > m
    internal = internal & ~overflow
    nch = torch.where(overflow, 0, nch).to(torch.int32)
    total_children = torch.sum(nch).to(torch.int32)
    child0 = (state.n_nodes + torch.cumsum(nch, 0) - nch).to(torch.int32)

    # child class frequencies (K, H, C)
    hist_best = hist[rows, best_attr]                             # (K, B, C)
    csum = torch.cumsum(hist_best, dim=1)
    left = csum[rows, torch.clamp_min(sb, 0).long()]              # (K, C)
    known = csum[:, -1, :]
    right = known - left
    cont_freq = torch.cat(
        [torch.stack([left, right], dim=1),
         torch.zeros((k, h_dim - 2, c_dim), dtype=torch.float32,
                     device=dev)], dim=1)
    disc_freq = hist_best[:, :h_dim, :]
    disc_mask = (torch.arange(h_dim, device=dev)[None, :] < nch_attr[:, None])
    disc_freq = torch.where(disc_mask[:, :, None], disc_freq, 0.0)
    child_freq = torch.where(is_cont[:, None, None], cont_freq, disc_freq)

    # unknown-valued cases go to the heaviest child
    unk = unknown[rows, best_attr]                                # (K, C)
    child_w = torch.sum(child_freq, dim=-1)                       # (K, H)
    in_range = (torch.arange(h_dim, device=dev)[None, :]
                < torch.clamp_min(nch_attr, 1)[:, None])
    heaviest = torch.argmax(torch.where(in_range, child_w, float("-inf")),
                           dim=-1).to(torch.int32)                # (K,)
    onehot = torch.nn.functional.one_hot(heaviest.long(), h_dim).to(
        torch.float32)
    child_freq = child_freq + onehot[:, :, None] * unk[:, None, :]

    parent_class = tree.node_class[ids_safe]
    cw = torch.sum(child_freq, dim=-1)
    child_class = torch.where(cw > EPS_W, torch.argmax(child_freq, dim=-1),
                              parent_class[:, None]).to(torch.int32)

    # ---- scatter node results (invalid slots write the dump row m) -------
    tree.node_attr[ids] = torch.where(internal, best_attr, -1).to(torch.int32)
    tree.node_split_bin[ids] = torch.where(internal & is_cont, sb,
                                           -1).to(torch.int32)
    tree.node_child0[ids] = torch.where(internal, child0, 0).to(torch.int32)
    tree.node_nchild[ids] = nch
    state.status[ids] = torch.where(internal, GrowState.STATUS_INTERNAL,
                                    GrowState.STATUS_LEAF).to(torch.int32)

    # ---- scatter children --------------------------------------------------
    j = torch.arange(h_dim, dtype=torch.int32, device=dev)[None, :]
    child_ids = child0[:, None] + j                               # (K, H)
    child_live = internal[:, None] & (j < nch[:, None])
    cids = torch.where(child_live, child_ids, m).reshape(-1).long()
    tree.node_class[cids] = child_class.reshape(-1)
    tree.node_freq[cids] = child_freq.reshape(-1, c_dim)
    tree.node_depth[cids] = (depth_k[:, None] + 1).expand(k, h_dim).reshape(
        -1).to(torch.int32)
    with tracer.span("wait.status"):     # a blocking scalar copy, as above
        state.status[cids] = GrowState.STATUS_OPEN
    attr_ids = torch.arange(a_dim, device=dev)[None, :]
    child_active = state.active[ids_safe] & ~(
        (~is_cont)[:, None] & (attr_ids == best_attr[:, None]))
    state.active[cids] = child_active[:, None, :].expand(
        k, h_dim, a_dim).reshape(-1, a_dim)

    # ---- route cases to their child (the feedback edge) -------------------
    part = slot >= 0
    slot_safe = torch.clamp_min(slot, 0).long()
    a_case = best_attr[slot_safe]
    b_case = x.gather(1, a_case[:, None])[:, 0]
    j_cont = torch.where(b_case <= sb[slot_safe], 0, 1).to(torch.int32)
    j_case = torch.where(is_cont[slot_safe], j_cont, b_case)
    j_case = torch.where(b_case < 0, heaviest[slot_safe], j_case)
    new_node = child0[slot_safe] + j_case
    case_node = torch.where(part & internal[slot_safe], new_node,
                            state.case_node).to(torch.int32)

    n_nodes = (state.n_nodes + total_children).to(torch.int32)
    tree.n_nodes = n_nodes
    new_state = GrowState(
        tree=tree, status=state.status, active=state.active,
        case_node=case_node, n_nodes=n_nodes,
        overflow=state.overflow | overflow)
    stats = dict(
        n_processed=torch.sum(valid.to(torch.int32)),
        n_active=torch.sum(part.to(torch.int32)),
        n_internal=torch.sum(internal.to(torch.int32)),
        n_children=total_children,
        max_r=torch.amax(torch.where(valid, total_w, 0.0)),
        nap_nodes=torch.sum(cost_models.build_att_test(
            cfg.cost_model, n_total_cases=float(prob.n_cases),
            r=total_w, c=torch.sum(active_k, -1).to(torch.float32),
            alpha=cfg.alpha).to(torch.int32) * valid.to(torch.int32)),
        overflow=new_state.overflow,
    )
    return new_state, stats


def _split_post_cuda(state: GrowState, pre: dict, att: dict,
                     x: torch.Tensor, attr_is_cont: torch.Tensor,
                     n_bins: torch.Tensor, *, prob: FrontierProblem,
                     tracer=NULL
                     ) -> tuple[GrowState, dict[str, torch.Tensor]]:
    """splitPost on two kernels (``kernels.split_post``): the node arrays,
    ``status``, ``active`` and ``case_node`` updated in place; ``n_nodes``,
    ``overflow`` and the statistics views of the node kernel's output.
    Of a state with the open range, the kernels also write the next
    splitPre over ``pre``, in place (the routing kernel runs after the node
    kernel, the planes' only reader), and the next live list over the
    range's (this superstep's histogram, its reader, ran before them on
    the stream).  Nothing waits for the card."""
    cfg = prob.cfg
    rng = state.open_range
    ahead = {} if rng is None else dict(
        ahead=pre, lo=rng.bounds[0], min_objs=cfg.min_objs,
        max_depth=cfg.max_depth, live=rng.live)
    with tracer.span("kernel.split_post"):
        bounds, overflow, stats = post_kernels.split_post(
            state.tree, state.status, state.active, state.case_node,
            state.n_nodes, state.overflow, pre, att, x, attr_is_cont,
            n_bins, cost_model=cfg.cost_model,
            n_total_cases=float(prob.n_cases), alpha=cfg.alpha, **ahead)
    tree = state.tree
    tree.n_nodes = bounds[1]
    nxt = None if rng is None else OpenRange(
        bounds=bounds, pre=dict(pre, n_open=None), live=rng.live,
        listed=True)
    return GrowState(tree=tree, status=state.status, active=state.active,
                     case_node=state.case_node, n_nodes=bounds[1],
                     overflow=overflow, open_range=nxt), stats


def superstep(state: GrowState, x: torch.Tensor, y: torch.Tensor,
              w: torch.Tensor, attr_is_cont: torch.Tensor,
              n_bins: torch.Tensor, *, prob: FrontierProblem,
              impl: str = "torch", tracer=NULL
              ) -> tuple[GrowState, dict[str, torch.Tensor]]:
    """One superstep: splitPre -> splitAtt -> splitPost, each a span of
    ``tracer`` (the host's time in the phase, the waits it makes itself
    included).  Updates the state's node arrays in place (on
    ``impl="cuda"`` its cases' nodes too) and returns the new state."""
    with tracer.span("splitPre"):
        pre = split_pre(state, prob=prob, tracer=tracer)
    with tracer.span("splitAtt"):
        att = split_att(state, pre, x, y, w, attr_is_cont, n_bins,
                        prob=prob, impl=impl, tracer=tracer)
    with tracer.span("splitPost"):
        return split_post(state, pre, att, x, attr_is_cont, n_bins,
                          prob=prob, impl=impl, tracer=tracer)


# --------------------------------------------------------------------------
# Full build
# --------------------------------------------------------------------------

def _open_left(state: GrowState, cfg: GrowConfig, tracer) -> bool:
    """The loop's test, any node still open: the JAX build's
    ``lax.while_loop`` condition, a wait for the device here.  Of a state
    with the open range, the one read of its three words, which also gives
    the coming superstep's ``n_open`` and ``n_live``."""
    rng = state.open_range
    with tracer.span("wait.loop"):
        if rng is not None:
            lo, n_nodes, rng.n_live = rng.bounds.tolist()
            rng.pre["n_open"] = min(cfg.frontier_slots, n_nodes - lo)
            return n_nodes > lo
        return bool(torch.any(state.status[:cfg.max_nodes]
                              == GrowState.STATUS_OPEN))


def _read_stats(pending: list[dict[str, torch.Tensor]]
                ) -> list[dict[str, Any]]:
    """The supersteps' statistics, left on the device, as the rows
    ``.item()`` gives, in one read: each value (an int32 count, a float32
    weight, a flag) is exact in float64."""
    keys = list(pending[0])
    cols = [torch.stack([s[k] for s in pending]) for k in keys]
    cast = [bool if c.dtype == torch.bool
            else float if c.is_floating_point() else int for c in cols]
    values = torch.stack([c.to(torch.float64) for c in cols], 1).tolist()
    return [{k: f(v) for k, f, v in zip(keys, cast, row)} for row in values]


def build(ds: BinnedDataset, cfg: GrowConfig = GrowConfig(), *,
          impl: str | None = None, device=None, collect_stats: bool = False,
          tracer: Any = None, metrics: Any = None,
          attr_mask: Any = None, case_w: Any = None,
          ) -> Tree | tuple[Tree, list[dict[str, Any]]]:
    """Grow a C4.5 tree with the frontier engine on ``device``.

    ``device=None`` means ``"cuda"``.  ``impl`` defaults to ``"cuda"`` (the
    hand-written kernels) on a CUDA device and ``"torch"`` (their plain
    versions) on the CPU; ``impl="cuda"`` on the CPU raises.

    ``collect_stats=True`` also returns one row of scheduling statistics
    per superstep (NP vs NAP decisions per the configured cost model; the
    JAX rows' keys, plus ``overflow``: capacity has forced early leaves).
    The rows also feed the metrics registry (``metrics``, default
    :data:`repro_torch.obs.metrics.REGISTRY`): ``frontier_supersteps_total``,
    ``frontier_active_cases``, ``frontier_open_nodes``,
    ``frontier_nap_nodes_total`` and ``frontier_children_total``.

    With an *enabled* ``tracer`` (:class:`repro_torch.obs.trace.Tracer`)
    the build runs as the spans of the module's docstring, and the
    registry is fed as well.  The statistics then stay on the device
    until the loop ends and are read once (``wait.stats``), where each
    superstep would otherwise wait for them; the tracer also gets a
    ``frontier.n_active`` counter sample a superstep, stamped with the
    superstep's start.  Without stats it still returns the tree alone.
    With tracing disabled (``None`` or :data:`repro_torch.obs.trace.NULL`)
    and no stats, the loop runs untraced, with no metric.

    ``attr_mask`` (bool (A,)) restricts the split search to a subset of
    attributes; ``case_w`` (f32 (N,)) overrides the per-case weights.
    """
    if cfg.unknown_fractional:
        raise ValueError("frontier engine routes unknowns to the heaviest "
                         "child; fractional unknowns are not supported")
    dev = resolve_device(device)
    impl = impl or ("cuda" if dev.type == "cuda" else "torch")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA device, got {dev}")
    tracer = NULL if tracer is None else tracer
    prob = FrontierProblem.from_dataset(ds, cfg)
    # the host's rows are pageable: the host waits for each copy
    with tracer.span("entry.copy"):
        x = torch.as_tensor(ds.x, dtype=torch.int32).to(dev).contiguous()
        y = torch.as_tensor(ds.y, dtype=torch.int32).to(dev)
        w = torch.as_tensor(np.asarray(ds.w if case_w is None else case_w,
                                       np.float32)).to(dev)
        mask = (None if attr_mask is None
                else torch.as_tensor(np.asarray(attr_mask, bool)).to(dev))
        cont = torch.as_tensor(ds.attr_is_cont, dtype=torch.bool).to(dev)
        nb = torch.as_tensor(ds.n_bins, dtype=torch.int32).to(dev)
    m = cfg.max_nodes
    traced = tracer.enabled
    observed = collect_stats or traced
    if observed:
        from repro_torch.obs import metrics as obs_metrics
        reg = metrics if metrics is not None else obs_metrics.REGISTRY
        m_steps = reg.counter("frontier_supersteps_total")
        m_active = reg.gauge("frontier_active_cases")
        m_open = reg.gauge("frontier_open_nodes")
        m_nap = reg.counter("frontier_nap_nodes_total")
        m_children = reg.counter("frontier_children_total")

    rows: list[dict[str, Any]] = []
    pending, starts = [], []        # traced: the statistics left on device
    with tracer.span("entry.init"):
        state = init_state(prob, y, w, mask, tracer,
                           open_range=impl == "cuda")
        left = _open_left(state, cfg, tracer)
    step = 0
    while left:
        with tracer.span("superstep", step=step) as span:
            state, stats = superstep(state, x, y, w, cont, nb, prob=prob,
                                     impl=impl, tracer=tracer)
            if traced:
                pending.append(stats)
                starts.append(span.ts)
            elif collect_stats:
                rows.append({key: v.item() for key, v in stats.items()})
            left = _open_left(state, cfg, tracer)
        step += 1
    if traced:
        with tracer.span("wait.stats"):
            rows = _read_stats(pending)
    if observed:
        for i, row in enumerate(rows):
            m_steps.inc()
            m_active.set(row["n_active"])
            m_open.set(row["n_processed"])
            m_nap.inc(row["nap_nodes"])
            m_children.inc(row["n_children"])
            if traced:
                tracer.counter("frontier.n_active", ts=starts[i],
                               value=row["n_active"])
    t = state.tree
    tree = Tree(**{f.name: getattr(t, f.name)[:m]
                   for f in dataclasses.fields(Tree) if f.name != "n_nodes"},
                n_nodes=state.n_nodes)
    return (tree, rows) if collect_stats else tree


def build_farm(ds: BinnedDataset, cfg: GrowConfig = GrowConfig(), **kw):
    """Grow the same tree through the supervised *threaded* farm.

    The host-side, fault-tolerant counterpart of :func:`build`: workers may
    crash, hang past ``FaultPolicy.task_deadline`` or die permanently and
    the result is still elementwise-equal to the oracle (and hence to the
    frontier engine).  See :func:`repro_torch.core.farm_build.build` for
    the keyword surface (``n_workers``, ``fault``, ``injector``, ``policy``,
    ``device``, ...).
    """
    from repro_torch.core import farm_build
    return farm_build.build(ds, cfg, **kw)
