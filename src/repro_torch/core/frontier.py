"""Level-synchronous frontier tree growth on torch tensors.

The torch counterpart of the JAX package's frontier engine.  The farm's task
stream is a frontier of open nodes, drained K = ``GrowConfig.frontier_slots``
at a time per superstep:

  splitPre   -> frontier selection and batched stop tests
  splitAtt   -> the (node, attr, bin, class) histogram and the gain pass
  splitPost  -> argmax, child allocation and case re-routing

Open nodes are taken in ascending id order and children are allocated
contiguously in slot order, so node ids are the sequential oracle's
breadth-first ids and trees compare elementwise with it.

``impl="cuda"`` runs splitAtt on the hand-written CUDA kernels (histogram,
then the fused split gain); ``impl="torch"`` runs their plain versions.
With ``GrowConfig.compact`` set, both gather the live cases first.  Per-node
state arrays carry one extra dump row (index M) that absorbs the writes of
unused slots, in place of the JAX scatters' ``mode="drop"``; readers only
look at rows below M.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import cost_models, entropy
from repro_torch.core.binning import BinnedDataset
from repro_torch.core.config import GrowConfig
from repro_torch.core.tree import Tree
from repro_torch.kernels import compaction, histogram, ref, split_gain

EPS_W = entropy.EPS_W
IMPLS = ("cuda", "torch")


@dataclasses.dataclass
class GrowState:
    tree: Tree                 # arrays of M+1 rows (row M = dump row)
    status: torch.Tensor       # int32 (M+1,): 0 empty 1 open 2 internal 3 leaf
    active: torch.Tensor       # bool (M+1, A): attributes active at each node
    case_node: torch.Tensor    # int32 (N,): current node of each case
    n_nodes: torch.Tensor      # int32 0-d
    overflow: torch.Tensor     # bool 0-d: capacity forced early leaves

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
               attr_mask: torch.Tensor | None = None) -> GrowState:
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
    status[0] = GrowState.STATUS_OPEN
    return GrowState(
        tree=tree, status=status, active=active,
        case_node=torch.zeros((prob.n_cases,), dtype=torch.int32, device=dev),
        n_nodes=torch.ones((), dtype=torch.int32, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev))


# --------------------------------------------------------------------------
# splitAtt's two kernels
# --------------------------------------------------------------------------

def _histogram(x, y, w, slot, *, prob: FrontierProblem, impl: str):
    cfg = prob.cfg
    kw = dict(n_slots=cfg.frontier_slots, n_bins=prob.n_bins_max,
              n_classes=prob.n_classes)
    if cfg.compact:
        x, y, w, slot = compaction.live_cases(x, y, w, slot)
    if impl == "torch":
        return ref.frontier_histogram_ref(x, y, w, slot, **kw)
    return histogram.frontier_histogram(x, y, w, slot, block_t=cfg.block_t,
                                        block_k=cfg.block_k, **kw)


def _gains(hist, total_w, attr_is_cont, n_bins, *, prob: FrontierProblem,
           impl: str):
    """(K, A) score / split-bin planes from the (K, A, B, C) histogram."""
    cfg = prob.cfg
    kw = dict(min_objs=cfg.min_objs, criterion=cfg.criterion)
    if impl == "torch":
        return ref.split_gain_ref(hist, total_w, attr_is_cont, n_bins, **kw)
    return split_gain.split_gain(hist, total_w, attr_is_cont, n_bins,
                                 block_b=cfg.block_b, **kw)


# --------------------------------------------------------------------------
# One superstep = splitPre + splitAtt + splitPost over K open nodes.
# --------------------------------------------------------------------------

def split_pre(state: GrowState, *, prob: FrontierProblem
              ) -> dict[str, torch.Tensor]:
    """Frontier selection + stop tests on stored node frequencies."""
    cfg = prob.cfg
    m, k = cfg.max_nodes, cfg.frontier_slots
    tree = state.tree
    dev = state.status.device

    # ---- the first K open node ids, ascending (= breadth-first), padded
    # with m: nonzero returns them sorted
    ids = torch.nonzero(state.status[:m] == GrowState.STATUS_OPEN
                        ).flatten()[:k]
    ids = torch.nn.functional.pad(ids, (0, k - ids.numel()), value=m)
    valid = ids < m
    ids_safe = torch.clamp_max(ids, m - 1)

    node_to_slot = torch.full((m + 1,), -1, dtype=torch.int32, device=dev)
    node_to_slot[ids] = torch.arange(k, dtype=torch.int32, device=dev)
    slot = node_to_slot[state.case_node.long()]                   # (N,)

    # ---- stop tests on stored frequencies
    freq = torch.where(valid[:, None], tree.node_freq[ids_safe], 0.0)
    total_w = torch.sum(freq, dim=-1)
    depth_k = tree.node_depth[ids_safe]
    pure = torch.sum((freq > EPS_W).to(torch.int32), -1) <= 1
    small = total_w < 2.0 * cfg.min_objs
    deep = depth_k >= cfg.max_depth
    return dict(ids=ids, valid=valid, ids_safe=ids_safe, slot=slot,
                total_w=total_w, depth_k=depth_k,
                pre_leaf=pure | small | deep)


def split_att(state: GrowState, pre: dict, x: torch.Tensor, y: torch.Tensor,
              w: torch.Tensor, attr_is_cont: torch.Tensor,
              n_bins: torch.Tensor, *, prob: FrontierProblem, impl: str
              ) -> dict[str, torch.Tensor]:
    """The hot phase: histogram + gain over (node, attribute)."""
    b_dim = prob.n_bins_max
    hist_u = _histogram(x, y, w, pre["slot"], prob=prob, impl=impl)
    hist = hist_u[:, :, :b_dim, :]
    unknown = hist_u[:, :, b_dim, :]                              # (K, A, C)
    score, split_bin = _gains(hist, pre["total_w"], attr_is_cont, n_bins,
                              prob=prob, impl=impl)
    active_k = state.active[pre["ids_safe"]] & pre["valid"][:, None]
    best_attr, _, has_split = entropy.pick_best_attribute(score, active_k)
    return dict(hist=hist, unknown=unknown, split_bin=split_bin,
                active_k=active_k, best_attr=best_attr, has_split=has_split)


def split_post(state: GrowState, pre: dict, att: dict, x: torch.Tensor,
               attr_is_cont: torch.Tensor, n_bins: torch.Tensor, *,
               prob: FrontierProblem
               ) -> tuple[GrowState, dict[str, torch.Tensor]]:
    """Argmax done: allocate children, scatter results, route cases."""
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


def superstep(state: GrowState, x: torch.Tensor, y: torch.Tensor,
              w: torch.Tensor, attr_is_cont: torch.Tensor,
              n_bins: torch.Tensor, *, prob: FrontierProblem,
              impl: str = "torch"
              ) -> tuple[GrowState, dict[str, torch.Tensor]]:
    """One superstep: splitPre -> splitAtt -> splitPost.  Updates the
    state's node arrays in place and returns the new state."""
    pre = split_pre(state, prob=prob)
    att = split_att(state, pre, x, y, w, attr_is_cont, n_bins, prob=prob,
                    impl=impl)
    return split_post(state, pre, att, x, attr_is_cont, n_bins, prob=prob)


# --------------------------------------------------------------------------
# Full build
# --------------------------------------------------------------------------

def resolve_device(device=None) -> torch.device:
    """``None`` means the card; asking for CUDA without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain torch path on the CPU")
    return dev


def build(ds: BinnedDataset, cfg: GrowConfig = GrowConfig(), *,
          impl: str | None = None, device=None, collect_stats: bool = False,
          attr_mask: Any = None, case_w: Any = None,
          ) -> Tree | tuple[Tree, list[dict[str, Any]]]:
    """Grow a C4.5 tree with the frontier engine on ``device``.

    ``device=None`` means ``"cuda"``.  ``impl`` defaults to ``"cuda"`` (the
    hand-written kernels) on a CUDA device and ``"torch"`` (their plain
    versions) on the CPU; ``impl="cuda"`` on the CPU raises.

    ``collect_stats=True`` also returns one row of scheduling statistics
    per superstep (NP vs NAP decisions per the configured cost model; the
    JAX rows' keys, plus ``overflow``: capacity has forced early leaves).
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
    prob = FrontierProblem.from_dataset(ds, cfg)
    x = torch.as_tensor(ds.x, dtype=torch.int32).to(dev).contiguous()
    y = torch.as_tensor(ds.y, dtype=torch.int32).to(dev)
    w = torch.as_tensor(np.asarray(ds.w if case_w is None else case_w,
                                   np.float32)).to(dev)
    mask = (None if attr_mask is None
            else torch.as_tensor(np.asarray(attr_mask, bool)).to(dev))
    cont = torch.as_tensor(ds.attr_is_cont, dtype=torch.bool).to(dev)
    nb = torch.as_tensor(ds.n_bins, dtype=torch.int32).to(dev)
    m = cfg.max_nodes

    state = init_state(prob, y, w, mask)
    rows: list[dict[str, Any]] = []
    # The JAX build's lax.while_loop is a host loop here: its condition
    # waits for the device once per superstep.
    while bool(torch.any(state.status[:m] == GrowState.STATUS_OPEN)):
        state, stats = superstep(state, x, y, w, cont, nb, prob=prob,
                                 impl=impl)
        if collect_stats:
            rows.append({key: v.item() for key, v in stats.items()})
    t = state.tree
    tree = Tree(**{f.name: getattr(t, f.name)[:m]
                   for f in dataclasses.fields(Tree) if f.name != "n_nodes"},
                n_nodes=state.n_nodes)
    return (tree, rows) if collect_stats else tree
