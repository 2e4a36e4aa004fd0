"""Fixed-capacity array decision tree on torch tensors.

The same layout as the JAX package's ``Tree``, so trees cross between the
packages field by field (:func:`tree_from_numpy`, :meth:`Tree.to_numpy`)
and compare with :func:`trees_equal` (capacity M, C classes):

  node_attr[i]      int32  attribute tested at node i, -1 for a leaf
  node_split_bin[i] int32  continuous: threshold bin (test: x <= bin);
                           discrete: -1 (child index == the value's bin)
  node_child0[i]    int32  id of the first child (children are contiguous)
  node_nchild[i]    int32  number of children (0 for leaves)
  node_class[i]     int32  majority class (prediction fallback at every node)
  node_freq[i, c]   f32    weighted class frequencies seen at the node
  node_depth[i]     int32  root = 0
  n_nodes           int32  live prefix of the arrays (0-d tensor)
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

FIELDS = ("node_attr", "node_split_bin", "node_child0", "node_nchild",
          "node_class", "node_freq", "node_depth", "n_nodes")


@dataclasses.dataclass
class Tree:
    node_attr: torch.Tensor
    node_split_bin: torch.Tensor
    node_child0: torch.Tensor
    node_nchild: torch.Tensor
    node_class: torch.Tensor
    node_freq: torch.Tensor
    node_depth: torch.Tensor
    n_nodes: torch.Tensor

    @staticmethod
    def empty(capacity: int, n_classes: int, device="cpu") -> "Tree":
        def full(shape, value, dtype=torch.int32):
            return torch.full(shape, value, dtype=dtype, device=device)
        return Tree(
            node_attr=full((capacity,), -1),
            node_split_bin=full((capacity,), -1),
            node_child0=full((capacity,), 0),
            node_nchild=full((capacity,), 0),
            node_class=full((capacity,), 0),
            node_freq=full((capacity, n_classes), 0.0, torch.float32),
            node_depth=full((capacity,), 0),
            n_nodes=full((), 0),
        )

    # ---- host-side conveniences ----

    def to_numpy(self) -> "Tree":
        """The same tree with numpy fields (as the JAX ``Tree.to_numpy``)."""
        return Tree(**{f: np.asarray(torch.as_tensor(getattr(self, f)).cpu())
                       for f in FIELDS})

    @property
    def size(self) -> int:
        return int(self.n_nodes)

    @property
    def depth(self) -> int:
        n = self.size
        return int(np.max(self.to_numpy().node_depth[:n])) if n else 0

    @property
    def n_leaves(self) -> int:
        n = self.size
        return int(np.sum(self.to_numpy().node_nchild[:n] == 0))

    def pretty(self, max_nodes: int = 40) -> str:
        t = self.to_numpy()
        lines = []
        for i in range(min(self.size, max_nodes)):
            pad = "  " * int(t.node_depth[i])
            if t.node_nchild[i] == 0:
                lines.append(f"{pad}#{i} leaf -> class {int(t.node_class[i])}")
            else:
                lines.append(
                    f"{pad}#{i} attr {int(t.node_attr[i])}"
                    f" bin<={int(t.node_split_bin[i])}"
                    f" children [{int(t.node_child0[i])}.."
                    f"{int(t.node_child0[i]) + int(t.node_nchild[i]) - 1}]")
        if self.size > max_nodes:
            lines.append(f"... ({self.size - max_nodes} more)")
        return "\n".join(lines)


def tree_from_numpy(fields: Mapping[str, np.ndarray], device) -> Tree:
    """A :class:`Tree` on ``device`` from arrays named as the JAX ``Tree``'s
    fields (``node_attr`` ... ``n_nodes``)."""
    dtypes = {f: torch.int32 for f in FIELDS}
    dtypes["node_freq"] = torch.float32
    return Tree(**{f: torch.tensor(np.asarray(fields[f]), dtype=dtypes[f],
                                   device=device)
                   for f in FIELDS})


def descend_once(attr_is_cont: torch.Tensor, node: torch.Tensor,
                 x_row_bins: torch.Tensor, *, node_attr: torch.Tensor,
                 node_split_bin: torch.Tensor, node_child0: torch.Tensor,
                 node_nchild: torch.Tensor, heavy: torch.Tensor
                 ) -> torch.Tensor:
    """One routing step for a batch of cases sitting at ``node``.

    ``heavy`` is the precomputed :func:`heavy_child_table`.
    """
    node = node.long()
    attr = node_attr[node]
    nchild = node_nchild[node]
    a_safe = torch.clamp_min(attr, 0).long()
    b = x_row_bins.gather(1, a_safe[:, None])[:, 0]
    cont = attr_is_cont[a_safe]
    child_cont = torch.where(b <= node_split_bin[node], 0, 1)
    child = torch.where(cont, child_cont, b)
    # Unknown value: follow the heaviest child, as the build routed it.
    child = torch.where(b < 0, heavy[node], child)
    child = torch.minimum(torch.clamp_min(child, 0),
                          torch.clamp_min(nchild - 1, 0))
    nxt = node_child0[node] + child
    return torch.where(nchild == 0, node, nxt).to(torch.int32)


def heavy_child_table(node_child0: torch.Tensor, node_nchild: torch.Tensor,
                      node_freq: torch.Tensor) -> torch.Tensor:
    """Per-node sibling rank of the heaviest child, exact for any arity.

    ``heavy[i]`` is the 0-based index among node i's children of the child
    with the largest total weight (first on ties); 0 for leaves.  Relies on
    the breadth-first layout every engine emits: children are contiguous and
    ``node_child0`` is non-decreasing over internal nodes, so a cumulative
    max over block-start marks recovers each node's parent.
    """
    m = node_child0.shape[0]
    dev = node_child0.device
    ids = torch.arange(m, dtype=torch.int32, device=dev)
    internal = node_nchild > 0
    marks = torch.full((m,), -1, dtype=torch.int32, device=dev)
    marks.scatter_reduce_(0, torch.where(internal, node_child0, 0).long(),
                          torch.where(internal, ids, -1), "amax",
                          include_self=True)
    parent = torch.cummax(marks, dim=0).values
    p_idx = torch.where(parent >= 0, parent, 0).long()
    rank = ids - node_child0[p_idx]
    # Padding past the live prefix inherits the last block's parent from the
    # cummax: the rank-range check rules those positions out.
    is_child = (parent >= 0) & (rank >= 0) & (rank < node_nchild[p_idx])
    w = torch.sum(node_freq, dim=-1)
    neg = torch.tensor(float("-inf"), dtype=w.dtype, device=dev)
    max_w = torch.full((m,), float("-inf"), dtype=w.dtype, device=dev)
    max_w.scatter_reduce_(0, p_idx, torch.where(is_child, w, neg), "amax",
                          include_self=True)
    is_best = is_child & (w >= max_w[p_idx])
    big = 1 << 30
    heavy = torch.full((m,), big, dtype=torch.int32, device=dev)
    heavy.scatter_reduce_(0, p_idx, torch.where(is_best, rank, big).to(
        torch.int32), "amin", include_self=True)
    return torch.where(internal & (heavy < big), heavy, 0).to(torch.int32)


def predict(tree: Tree, x_bins, attr_is_cont,
            max_depth: int | None = None) -> torch.Tensor:
    """Class prediction for binned cases ``x_bins (N, A)`` on the tree's
    device.  ``max_depth`` defaults to the live prefix's depth + 1, so deep
    trees classify at their true leaves."""
    dev = tree.node_attr.device
    if max_depth is None:
        max_depth = tree.depth + 1 if tree.size else 1
    x_bins = torch.as_tensor(x_bins, dtype=torch.int32).to(dev)
    attr_is_cont = torch.as_tensor(attr_is_cont, dtype=torch.bool).to(dev)
    node = torch.zeros((x_bins.shape[0],), dtype=torch.int32, device=dev)
    heavy = heavy_child_table(tree.node_child0, tree.node_nchild,
                              tree.node_freq)
    for _ in range(max_depth):
        node = descend_once(attr_is_cont, node, x_bins,
                            node_attr=tree.node_attr,
                            node_split_bin=tree.node_split_bin,
                            node_child0=tree.node_child0,
                            node_nchild=tree.node_nchild, heavy=heavy)
    return tree.node_class[node.long()]


def trees_equal(a, b, *, freq_tol: float = 1e-3) -> bool:
    """Structural equality of the live prefixes (host-side).

    Takes any tree with ``to_numpy()`` and the field names above, so a tree
    of either package compares with a tree of the other.
    """
    a, b = a.to_numpy(), b.to_numpy()
    na, nb = int(a.n_nodes), int(b.n_nodes)
    if na != nb:
        return False
    for f in ("node_attr", "node_split_bin", "node_child0", "node_nchild",
              "node_class", "node_depth"):
        if not np.array_equal(getattr(a, f)[:na], getattr(b, f)[:na]):
            return False
    return bool(np.allclose(a.node_freq[:na], b.node_freq[:na],
                            atol=freq_tol, rtol=1e-4))
