"""Sequential YaDT oracle on torch tensors — the reference semantics for
every other engine.

A direct transliteration of the paper's Fig. 2/3/4 pseudo-code, as the JAX
package's ``core.c45``:

  tree::build       -> :func:`build` (breadth-first frontier queue, Fig. 4)
  node::splitPre    -> class frequencies + stop tests
  node::splitAtt(i) -> per-attribute gain via the shared histogram scorer
  node::splitPost   -> argmax, threshold, child creation

It runs on ``device`` (None: the card): a node's case indices and weights
are tensors there, its ``(A, B, C)`` histogram is plain torch (never the
CUDA histogram kernel, so that the oracle stays an independent check of
the kernels it judges) and its scores come from the same torch scorer as
the frontier engine's plain path (:mod:`repro_torch.core.entropy`).  The
per-node decisions are host Python, as in the reference; the node's small
vectors (class frequencies, the children's known weights) come to the host
for them.

Rounding follows the reference's numpy: weighted counts accumulate in
float64 and round to float32 once (``np.bincount(..., weights=)`` then
``astype``); a fractional child weight multiplies in float64 and rounds
(numpy 2 promotes a float32 array times an ``np.float64`` share); the
children's known weights stay float64 and their sum and argmax are numpy's
own, on the host.  A node's total weight (the reference's float32
``w.sum()``) is the float64 sum rounded to float32.

Being the semantic reference it also implements full C4.5 unknown handling
(fractional weights to all children) behind ``GrowConfig.unknown_fractional``.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from repro_torch.core import entropy
from repro_torch.core.binning import BinnedDataset
from repro_torch.core.config import GrowConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import Tree

EPS_W = 1e-7


@dataclasses.dataclass(frozen=True)
class DeviceDataset:
    """A :class:`BinnedDataset` with its columns on one device, shared
    read-only by the nodes of a build (and the farm's workers)."""

    ds: BinnedDataset
    x: torch.Tensor             # int64 (N, A); -1 = unknown
    y: torch.Tensor             # int64 (N,)
    attr_is_cont: torch.Tensor  # bool (A,)
    n_bins: torch.Tensor        # int32 (A,)

    @property
    def device(self) -> torch.device:
        return self.x.device

    def __getattr__(self, name):
        # n_cases, n_attrs, n_classes, max_bins, w ...: the dataset's own
        if name == "ds":
            raise AttributeError(name)
        return getattr(self.ds, name)


def on_device(ds, device) -> DeviceDataset:
    """``ds`` with its columns on ``device`` (``ds`` itself if it already
    is a :class:`DeviceDataset` there)."""
    dev = torch.device(device)
    if isinstance(ds, DeviceDataset):
        if ds.device == dev:
            return ds
        ds = ds.ds
    return DeviceDataset(
        ds=ds,
        x=torch.as_tensor(np.asarray(ds.x), dtype=torch.int64).to(dev),
        y=torch.as_tensor(np.asarray(ds.y), dtype=torch.int64).to(dev),
        attr_is_cont=torch.as_tensor(np.asarray(ds.attr_is_cont, bool)
                                     ).to(dev),
        n_bins=torch.as_tensor(np.asarray(ds.n_bins), dtype=torch.int32
                               ).to(dev))


@dataclasses.dataclass
class _Task:
    """A node task on the farm stream (paper's ff_task, weight = r cases)."""
    node_id: int
    idx: torch.Tensor      # int64 case indices at the node
    w: torch.Tensor        # f32 case weights (may be fractional: unknowns)
    active: np.ndarray     # bool (A,) attributes still active
    depth: int


@dataclasses.dataclass
class _Nodes:
    """Append-only builder for the Tree arrays (ids in BFS order)."""
    attr: list
    split_bin: list
    child0: list
    nchild: list
    cls: list
    freq: list
    depth: list

    @staticmethod
    def new() -> "_Nodes":
        return _Nodes([], [], [], [], [], [], [])

    def add(self, *, cls: int, freq: np.ndarray, depth: int) -> int:
        i = len(self.attr)
        self.attr.append(-1)
        self.split_bin.append(-1)
        self.child0.append(0)
        self.nchild.append(0)
        self.cls.append(cls)
        self.freq.append(freq)
        self.depth.append(depth)
        return i

    def finish(self, n_classes: int, capacity: int | None = None,
               device=None) -> Tree:
        n = len(self.attr)
        cap = capacity or n
        t = Tree.empty(cap, n_classes, device)
        dev = t.node_attr.device

        def put(field, values, dtype=np.int32):
            getattr(t, field)[:n] = torch.as_tensor(
                np.asarray(values, dtype)).to(dev)
        put("node_attr", self.attr)
        put("node_split_bin", self.split_bin)
        put("node_child0", self.child0)
        put("node_nchild", self.nchild)
        put("node_class", self.cls)
        put("node_freq", np.stack(self.freq), np.float32)
        put("node_depth", self.depth)
        t.n_nodes.fill_(n)
        return t


def node_histogram(ds, idx: torch.Tensor, w: torch.Tensor,
                   b_max: int | None = None) -> torch.Tensor:
    """(A, B, C) f32 weighted counts of known-valued cases at a node."""
    d = on_device(ds, idx.device)
    a_dim = d.n_attrs
    b_dim = b_max or d.max_bins
    c_dim = d.n_classes
    cells = a_dim * b_dim * c_dim
    xb = d.x[idx]                                            # (r, A)
    flat = (torch.arange(a_dim, device=idx.device) * (b_dim * c_dim)
            + xb * c_dim + d.y[idx][:, None])
    # unknown values (bin -1) add into a dump cell past the histogram
    flat = torch.where(xb >= 0, flat, cells)
    w64 = w.to(torch.float64)[:, None].expand_as(xb)
    hist = torch.zeros((cells + 1,), dtype=torch.float64, device=idx.device)
    hist.index_add_(0, flat.reshape(-1), w64.reshape(-1))
    return hist[:cells].to(torch.float32).reshape(a_dim, b_dim, c_dim)


def _class_counts(d: DeviceDataset, idx: torch.Tensor, w: torch.Tensor,
                  n_groups: int = 1, group: torch.Tensor | None = None
                  ) -> np.ndarray:
    """(n_groups, C) f32 host array of weighted class counts (float64
    accumulation, one rounding), the cases split by ``group``."""
    c_dim = d.n_classes
    key = d.y[idx] if group is None else group * c_dim + d.y[idx]
    out = torch.zeros((n_groups * c_dim,), dtype=torch.float64,
                      device=idx.device)
    out.index_add_(0, key, w.to(torch.float64))
    return out.to(torch.float32).reshape(n_groups, c_dim).cpu().numpy()


def class_frequencies(ds, idx: torch.Tensor, w: torch.Tensor) -> np.ndarray:
    """computeFrequencies (paper §2.2): weighted class counts at the node,
    a (C,) f32 host array."""
    return _class_counts(on_device(ds, idx.device), idx, w)[0]


def split_pre(freq: np.ndarray, depth: int, cfg: GrowConfig) -> bool:
    """onlyOneClass() || fewCases() (paper §2.3) — True = make a leaf."""
    total = float(freq.sum())
    pure = int((freq > EPS_W).sum()) <= 1
    return pure or total < 2 * cfg.min_objs or depth >= cfg.max_depth


def split_att(hist: torch.Tensor, total_w, ds, cfg: GrowConfig):
    """gainCalculation for every attribute at once (paper §2.6-7, Fig. 3).

    The shared torch scorer, so the oracle and the frontier engine's plain
    path produce identical scores for identical histograms.
    """
    d = on_device(ds, hist.device)
    return entropy.gains_from_histogram(
        hist, total_w=torch.as_tensor(total_w, dtype=torch.float32),
        attr_is_cont=d.attr_is_cont, n_bins=d.n_bins,
        min_objs=cfg.min_objs, criterion=cfg.criterion)


@dataclasses.dataclass
class SplitDecision:
    """Pure result of processing one node (splitPre+splitAtt+splitPost math).

    ``attr < 0`` means the node is a leaf.  Computing a decision mutates
    nothing — it is a function of (dataset, task) only — so the farm may
    retry it on any worker after a crash without corrupting the build
    (:mod:`repro_torch.core.farm_build`).  The children's cases and weights
    are tensors on the build's device; their frequencies are host arrays.
    """

    attr: int = -1
    split_bin: int = -1                 # threshold bin (continuous), else -1
    n_children: int = 0
    child_active: np.ndarray | None = None
    child_idx: list = dataclasses.field(default_factory=list)
    child_w: list = dataclasses.field(default_factory=list)
    child_freq: list = dataclasses.field(default_factory=list)
    child_cls: list = dataclasses.field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return self.attr < 0


def split_node(ds, cfg: GrowConfig, *, idx: torch.Tensor, w: torch.Tensor,
               active: np.ndarray, depth: int, freq: np.ndarray,
               cls: int) -> SplitDecision:
    """Process one node: the paper's splitPre/splitAtt/splitPost pipeline.

    Shared verbatim by the sequential oracle (:func:`build`) and the farm
    workers (:mod:`repro_torch.core.farm_build`), so both engines make
    identical split decisions.  ``ds`` is best a :class:`DeviceDataset` on
    ``idx``'s device (a :class:`BinnedDataset` is copied there first).
    """
    if split_pre(freq, depth, cfg):
        return SplitDecision()

    d = on_device(ds, idx.device)
    dev = d.device
    hist = node_histogram(d, idx, w)
    total_w = w.to(torch.float64).sum().to(torch.float32)
    score, split_bin = split_att(hist, total_w, d, cfg)
    best_attr, _, has_split = entropy.pick_best_attribute(
        score[None, :], torch.as_tensor(active).to(dev)[None, :])
    a, ok, sb = torch.stack([best_attr[0].long(), has_split[0].long(),
                             split_bin[best_attr[0].long()].long()]).tolist()
    if not ok:
        return SplitDecision()

    is_cont = bool(d.ds.attr_is_cont[a])
    n_children = 2 if is_cont else int(d.ds.n_bins[a])

    # --- partition cases over the children (paper §2.12-14) ---------------
    b_col = d.x[idx, a]
    known = b_col >= 0
    if is_cont:
        child_of = (b_col > sb).long()
    else:
        child_of = b_col
    # the unknown cases form group n_children, after the children's
    group = torch.where(known, child_of, n_children)
    ckw = torch.zeros((n_children + 1,), dtype=torch.float64, device=dev)
    ckw.index_add_(0, group, w.to(torch.float64))
    counts = torch.bincount(group, minlength=n_children + 1)
    host = torch.cat([ckw, counts.to(torch.float64)]).cpu().numpy()
    child_known_w = host[:n_children]
    counts = [int(c) for c in host[n_children + 1:]]
    w_known = float(child_known_w.sum())
    heaviest = int(np.argmax(child_known_w))

    # a stable sort keeps each group's cases in their order at the node
    order = torch.argsort(group, stable=True)
    parts_idx = torch.split(idx[order], counts)
    parts_w = torch.split(w[order], counts)
    idx_unk, w_unk = parts_idx[n_children], parts_w[n_children]
    child_idx: list[torch.Tensor] = []
    child_w: list[torch.Tensor] = []
    for j in range(n_children):
        ci, cw = parts_idx[j], parts_w[j]
        if counts[n_children]:
            if cfg.unknown_fractional:
                # Full C4.5: every child receives the unknown cases with
                # weight rescaled by its share of the known weight.
                share = child_known_w[j] / max(w_known, EPS_W)
                if share > 0:
                    ci = torch.cat([ci, idx_unk])
                    cw = torch.cat([cw, (w_unk.to(torch.float64)
                                         * float(share)).to(torch.float32)])
            elif j == heaviest:
                ci = torch.cat([ci, idx_unk])
                cw = torch.cat([cw, w_unk])
        child_idx.append(ci)
        child_w.append(cw)

    child_active = active.copy()
    if not is_cont:
        child_active[a] = False       # discrete attr consumed (paper §2.6)
    sizes = [len(ci) for ci in child_idx]
    child_of_case = torch.repeat_interleave(
        torch.arange(n_children, device=dev),
        torch.as_tensor(sizes).to(dev), output_size=sum(sizes))
    freqs = _class_counts(d, torch.cat(child_idx), torch.cat(child_w),
                          n_children, child_of_case)
    child_freq, child_cls = [], []
    for j in range(n_children):
        cfreq = freqs[j]
        ccls = int(np.argmax(cfreq)) if cfreq.sum() > EPS_W else int(cls)
        child_freq.append(cfreq)
        child_cls.append(ccls)
    return SplitDecision(attr=a, split_bin=sb if is_cont else -1,
                         n_children=n_children, child_active=child_active,
                         child_idx=child_idx, child_w=child_w,
                         child_freq=child_freq, child_cls=child_cls)


def root_task(ds: BinnedDataset, device, *, attr_mask=None, case_w=None
              ) -> tuple[torch.Tensor, torch.Tensor, np.ndarray]:
    """The root node's case indices, weights (on ``device``) and active
    attributes: every case, ``case_w`` (default the dataset's weights) and
    ``attr_mask`` (default every attribute)."""
    w_base = ds.w if case_w is None else case_w
    root_idx = torch.arange(ds.n_cases, dtype=torch.int64, device=device)
    root_w = torch.as_tensor(np.asarray(w_base, np.float32)).to(device)
    root_active = (np.ones(ds.n_attrs, dtype=bool) if attr_mask is None
                   else np.asarray(attr_mask, dtype=bool).copy())
    return root_idx, root_w, root_active


def build(ds: BinnedDataset, cfg: GrowConfig = GrowConfig(), *, device=None,
          task_trace: list | None = None, capacity: int | None = None,
          attr_mask=None, case_w=None) -> Tree:
    """Breadth-first C4.5 growth (paper Fig. 4, tree::build) on ``device``
    (None: the card; raises without one).

    ``task_trace``, when given, records one dict per processed node, in
    processing order, with the keys ``node_id``, ``parent`` (-1 at the
    root), ``r`` (cases), ``c`` (active attributes), ``n_children`` (0 for
    a leaf) and ``depth`` — the exact task DAG that
    :func:`repro_torch.core.simulate.simulate` replays (weights = r, as in
    the paper's WS policy).

    ``attr_mask`` (bool (A,)) restricts the split search to a subset of
    attributes and ``case_w`` (f32 (N,)) overrides the per-case weights —
    the ensemble trainer's per-tree feature-subset / bootstrap hooks
    (:mod:`repro_torch.ensemble.sampling`).
    """
    dev = resolve_device(device)
    d = on_device(ds, dev)
    nodes = _Nodes.new()
    root_idx, root_w, root_active = root_task(ds, dev, attr_mask=attr_mask,
                                              case_w=case_w)
    root_freq = class_frequencies(d, root_idx, root_w)
    root = nodes.add(cls=int(np.argmax(root_freq)), freq=root_freq, depth=0)
    q: deque[_Task] = deque()
    q.append(_Task(root, root_idx, root_w, root_active, 0))
    parent_of = {root: -1}

    while q:
        t = q.popleft()
        dec = split_node(d, cfg, idx=t.idx, w=t.w, active=t.active,
                         depth=t.depth, freq=nodes.freq[t.node_id],
                         cls=int(nodes.cls[t.node_id]))
        if dec.is_leaf:
            _trace(task_trace, t, parent_of, 0)
            continue

        # --- emit children in sibling order (BFS ids, same as frontier) ---
        nodes.attr[t.node_id] = dec.attr
        nodes.split_bin[t.node_id] = dec.split_bin
        nodes.nchild[t.node_id] = dec.n_children
        first = None
        for j in range(dec.n_children):
            cid = nodes.add(cls=dec.child_cls[j], freq=dec.child_freq[j],
                            depth=t.depth + 1)
            parent_of[cid] = t.node_id
            if first is None:
                first = cid
            q.append(_Task(cid, dec.child_idx[j], dec.child_w[j],
                           dec.child_active, t.depth + 1))
        nodes.child0[t.node_id] = first
        _trace(task_trace, t, parent_of, dec.n_children)

    return nodes.finish(ds.n_classes, capacity, dev)


def _trace(trace: list | None, t: _Task, parent_of: dict,
           n_children: int) -> None:
    if trace is not None:
        trace.append(dict(node_id=t.node_id, parent=parent_of[t.node_id],
                          r=len(t.idx), c=int(t.active.sum()),
                          n_children=n_children, depth=t.depth))
