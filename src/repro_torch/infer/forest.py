"""Packed forests: stacked node arrays + batched ensemble prediction.

A :class:`Forest` packs one or many trees into a padded structure-of-arrays
at a common capacity M: every node array gains a leading tree axis, so the
ensemble is a handful of ``(T, M, ...)`` tensors on one device, laid out
field for field as the JAX package's ``Forest``.  The heaviest-child table
is computed at pack time (:func:`repro_torch.core.tree.heavy_child_table`),
so unknown-value routing is exact for any split arity in every
implementation.

Implementations (all equal to the per-tree
:func:`repro_torch.core.tree.predict`):

  ``ref``   -- per-tree Python loop over ``tree.predict`` (the oracle);
  ``torch`` -- the batched plain version over all trees at once
               (:func:`repro_torch.kernels.ref.forest_predict_ref`, the
               counterpart of the JAX ``vmap``);
  ``cuda``  -- the hand-written traversal kernel
               (:func:`repro_torch.kernels.tree_infer.forest_predict`).

``impl=None`` means ``cuda`` on a CUDA forest and ``torch`` on a CPU one.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.tree import Tree, heavy_child_table
from repro_torch.core.tree import predict as tree_predict
from repro_torch.kernels import ref, tree_infer

IMPLS = ("ref", "torch", "cuda")

#: Forest fields, in the JAX ``Forest``'s order (the registry's npz keys).
FIELDS = ("node_attr", "node_split_bin", "node_child0", "node_nchild",
          "node_class", "node_freq", "node_depth", "node_heavy", "n_nodes",
          "tree_weight")
_F32_FIELDS = ("node_freq", "tree_weight")


@dataclasses.dataclass
class Forest:
    """T trees stacked at common capacity M (C classes).

    The per-node fields of :class:`~repro_torch.core.tree.Tree` plus the
    heavy-child table and a per-tree vote weight.  ``n_nodes`` is the live
    prefix per tree; padding past it is leaf-shaped (nchild 0).  The
    tensors are not changed after packing: ``n_levels`` and the node table
    are computed once.
    """

    node_attr: torch.Tensor       # int32 (T, M)
    node_split_bin: torch.Tensor  # int32 (T, M)
    node_child0: torch.Tensor     # int32 (T, M)
    node_nchild: torch.Tensor     # int32 (T, M)
    node_class: torch.Tensor      # int32 (T, M)
    node_freq: torch.Tensor       # f32   (T, M, C)
    node_depth: torch.Tensor      # int32 (T, M)
    node_heavy: torch.Tensor      # int32 (T, M) sibling rank of heaviest child
    n_nodes: torch.Tensor         # int32 (T,)
    tree_weight: torch.Tensor     # f32   (T,) ensemble vote weight

    # ------------------------------------------------------------ properties
    @property
    def device(self) -> torch.device:
        return self.node_attr.device

    @property
    def n_trees(self) -> int:
        return int(self.node_attr.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.node_attr.shape[1])

    @property
    def n_classes(self) -> int:
        return int(self.node_freq.shape[-1])

    @functools.cached_property
    def n_levels(self) -> int:
        """Descent trip count: 1 + the deepest live node over all trees."""
        live = (torch.arange(self.capacity, device=self.device)[None, :]
                < self.n_nodes[:, None])
        return int(torch.where(live, self.node_depth, 0).max()) + 1

    # --------------------------------------------------------------- packing
    @staticmethod
    def pack(trees, *, weights=None, capacity: int | None = None,
             device=None) -> "Forest":
        """Stack trees' live prefixes at a common (padded) capacity on
        ``device`` (None: the card).  Takes trees of either package."""
        if not trees:
            raise ValueError("Forest.pack: need at least one tree")
        dev = resolve_device(device)
        host = [t.to_numpy() for t in trees]
        n_classes = {t.node_freq.shape[-1] for t in host}
        if len(n_classes) != 1:
            raise ValueError(f"trees disagree on n_classes: {n_classes}")
        c = n_classes.pop()
        sizes = [int(t.n_nodes) for t in host]
        m = max(max(sizes, default=1), 1)
        if capacity is not None:
            if capacity < m:
                raise ValueError(f"capacity {capacity} < largest tree {m}")
            m = capacity
        t_dim = len(host)

        def stack(field, fill, dtype, extra=()):
            out = np.full((t_dim, m, *extra), fill, dtype)
            for i, (tr, n) in enumerate(zip(host, sizes)):
                out[i, :n] = getattr(tr, field)[:n]
            return torch.as_tensor(out).to(dev)

        w = (np.ones(t_dim, np.float32) if weights is None
             else np.asarray(weights, np.float32))
        if w.shape != (t_dim,):
            raise ValueError(f"weights shape {w.shape} != ({t_dim},)")
        child0 = stack("node_child0", 0, np.int32)
        nchild = stack("node_nchild", 0, np.int32)
        freq = stack("node_freq", 0.0, np.float32, (c,))
        heavy = torch.stack([heavy_child_table(child0[i], nchild[i], freq[i])
                             for i in range(t_dim)])
        return Forest(
            node_attr=stack("node_attr", -1, np.int32),
            node_split_bin=stack("node_split_bin", -1, np.int32),
            node_child0=child0,
            node_nchild=nchild,
            node_class=stack("node_class", 0, np.int32),
            node_freq=freq,
            node_depth=stack("node_depth", 0, np.int32),
            node_heavy=heavy,
            n_nodes=torch.as_tensor(sizes, dtype=torch.int32).to(dev),
            tree_weight=torch.as_tensor(w).to(dev),
        )

    def tree(self, i: int) -> Tree:
        """Unpack tree ``i`` (capacity = the forest's common capacity)."""
        return Tree(**{f: getattr(self, f)[i] for f in (
            "node_attr", "node_split_bin", "node_child0", "node_nchild",
            "node_class", "node_freq", "node_depth", "n_nodes")})

    @functools.cached_property
    def _table(self) -> torch.Tensor:
        cols = torch.stack(
            [self.node_attr, self.node_split_bin, self.node_child0,
             self.node_nchild, self.node_heavy, self.node_class],
            dim=-1).to(torch.int32)
        pad = tree_infer.NODE_COLS - cols.shape[-1]
        return torch.nn.functional.pad(cols, (0, pad)).contiguous()

    def node_table(self) -> torch.Tensor:
        """(T, M, NODE_COLS) int32 table of the traversal kernel."""
        return self._table

    def to_numpy(self) -> dict[str, np.ndarray]:
        """Every field as a numpy array (the JAX ``Forest``'s dtypes)."""
        return {f: getattr(self, f).cpu().numpy() for f in FIELDS}


def forest_from_numpy(fields: Mapping[str, np.ndarray], device) -> Forest:
    """A :class:`Forest` on ``device`` from arrays named as the JAX
    ``Forest``'s fields (``node_attr`` ... ``tree_weight``)."""
    return Forest(**{
        f: torch.tensor(np.asarray(fields[f]), device=device,
                        dtype=torch.float32 if f in _F32_FIELDS
                        else torch.int32)
        for f in FIELDS})


# ----------------------------------------------------------------- prediction

def predict_per_tree(forest: Forest, x_bins, attr_is_cont, *,
                     impl: str | None = None, max_depth: int | None = None,
                     block_n: int | None = None) -> torch.Tensor:
    """(T, N) int32 leaf classes, one row per packed tree, on the forest's
    device."""
    dev = forest.device
    impl = impl or ("cuda" if dev.type == "cuda" else "torch")
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (one of {IMPLS})")
    if impl == "cuda" and dev.type != "cuda":
        raise ValueError(f"impl='cuda' needs a forest on a CUDA device, "
                         f"got {dev}")
    x_bins = torch.as_tensor(x_bins, dtype=torch.int32).to(dev).contiguous()
    attr_is_cont = torch.as_tensor(attr_is_cont, dtype=torch.bool).to(dev)
    if max_depth is None:
        max_depth = forest.n_levels
    if impl == "ref":
        return torch.stack([
            tree_predict(forest.tree(i), x_bins, attr_is_cont,
                         max_depth=max_depth)
            for i in range(forest.n_trees)])
    if impl == "torch":
        return ref.forest_predict_ref(forest.node_table(), x_bins,
                                      attr_is_cont, max_depth=max_depth)
    return tree_infer.forest_predict(forest.node_table(), x_bins,
                                     attr_is_cont, max_depth=max_depth,
                                     block_n=block_n)


def vote(per_tree: torch.Tensor, tree_weight: torch.Tensor, *,
         n_classes: int) -> torch.Tensor:
    """Aggregate (T, N) per-tree classes into (N,) int32 by weighted vote.

    The f32 tally adds the trees in ascending tree order.  Majority vote is
    the ``tree_weight == 1`` special case; ties break to the lowest class
    id (``torch.argmax`` returns the first maximum).
    """
    t_dim, n = per_tree.shape
    tally = torch.zeros((n, n_classes), dtype=torch.float32,
                        device=per_tree.device)
    w = tree_weight.to(device=per_tree.device, dtype=torch.float32)
    for t in range(t_dim):
        tally.scatter_add_(1, per_tree[t].long()[:, None],
                           w[t].expand(n, 1))
    return torch.argmax(tally, dim=-1).to(torch.int32)


def predict(forest: Forest, x_bins, attr_is_cont, *, impl: str | None = None,
            weighted: bool = True, max_depth: int | None = None,
            block_n: int | None = None) -> torch.Tensor:
    """(N,) ensemble prediction: per-tree descent + weighted majority vote.

    ``weighted=False`` ignores ``tree_weight`` (plain majority).  A 1-tree
    forest returns exactly that tree's predictions for every ``impl``.
    """
    per_tree = predict_per_tree(forest, x_bins, attr_is_cont, impl=impl,
                                max_depth=max_depth, block_n=block_n)
    w = forest.tree_weight if weighted \
        else torch.ones((forest.n_trees,), device=forest.device)
    return vote(per_tree, w, n_classes=forest.n_classes)
