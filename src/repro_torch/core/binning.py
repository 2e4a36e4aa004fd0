"""EC4.5 rank-space data representation (paper Sect. 3.2).

EC4.5/YaDT store each continuous value as an *index into the pre-sorted
attribute domain* computed once over the whole training set.  That makes the
per-node threshold search a pure integer problem and the final threshold
lookup ("the greatest value of A in the whole training set below the local
threshold", paper §2.9-10) an O(log d) binary search — here it is a
precomputed table lookup, because bin b's edge *is* that greatest value.

``fit`` produces a :class:`BinnedDataset`:

  * continuous attribute with ``|domain| <= max_bins``  →  **exact** rank
    space; bin b == the b-th smallest known value; C4.5 semantics preserved
    bit-for-bit.
  * continuous attribute with more distinct values      →  quantile bins
    (the RainForest/counting-sort regime EC4.5 switches to on narrow ranges,
    here made global); the approximation is confined to this module.
  * discrete attribute  →  bins are the category codes themselves.

Unknown values (NaN for continuous, negative codes for discrete) map to
bin -1 and carry C4.5 weighted-case semantics downstream.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

UNKNOWN = -1


@dataclasses.dataclass(frozen=True)
class BinnedDataset:
    """Columnar training set in rank space.  All engines consume this."""

    x: np.ndarray              # int32 (N, A); -1 = unknown
    y: np.ndarray              # int32 (N,) class labels in [0, n_classes)
    w: np.ndarray              # float32 (N,) case weights (C4.5 weighted cases)
    attr_is_cont: np.ndarray   # bool (A,)
    n_bins: np.ndarray         # int32 (A,) live bins per attribute
    bin_edges: tuple[np.ndarray, ...]  # per attr: float64 (n_bins,) upper edge
                               # of each bin == split threshold for `<= bin b`;
                               # for discrete attrs: the category codes.
    n_classes: int
    attr_names: tuple[str, ...] = ()

    @property
    def n_cases(self) -> int:
        return int(self.x.shape[0])

    @property
    def n_attrs(self) -> int:
        return int(self.x.shape[1])

    @property
    def max_bins(self) -> int:
        return int(self.n_bins.max()) if self.n_bins.size else 0

    def threshold_value(self, attr: int, split_bin: int) -> float:
        """Raw-space threshold of the split ``x[attr] <= split_bin``."""
        return float(self.bin_edges[attr][split_bin])

    def subset(self, idx: np.ndarray) -> "BinnedDataset":
        return dataclasses.replace(self, x=self.x[idx], y=self.y[idx],
                                   w=self.w[idx])


def _bin_continuous(col: np.ndarray, max_bins: int) -> tuple[np.ndarray, np.ndarray]:
    if max_bins < 1:
        raise ValueError(f"max_bins must be >= 1, got {max_bins}")
    known = ~np.isnan(col)
    binned = np.full(col.shape, UNKNOWN, dtype=np.int32)
    if not known.any():
        # All-unknown column: no domain, no edges — every case keeps bin -1
        # and the attribute can never split (its histogram is empty).
        return binned, np.zeros((0,), dtype=np.float64)
    vals = col[known].astype(np.float64)
    domain = np.unique(vals)
    if domain.size <= max_bins:
        # Exact rank space: bin == index of the value in the sorted domain.
        # A constant column degenerates to a single bin [value].
        binned[known] = np.searchsorted(domain, vals).astype(np.int32)
        return binned, domain
    # Quantile binning: edges are *actual domain values* so that the split
    # threshold is still "a value of A in the whole training set".
    qs = np.linspace(0.0, 1.0, max_bins + 1)[1:-1]
    cut = np.unique(np.quantile(domain, qs, method="nearest"))
    # Skewed quantiles may collapse onto the domain maximum; keep only cuts
    # strictly below it so the final edge (== domain max) is unique and no
    # trailing bin is structurally empty.  max_bins=1 (qs empty) and a fully
    # collapsed cut both degenerate to one bin covering the whole domain.
    cut = cut[cut < domain[-1]]
    # side="left": a value equal to cut[i] lands in bin i, whose upper edge is
    # cut[i] — so the split "x <= edge[b]" includes its own edge value.
    binned[known] = np.searchsorted(cut, vals, side="left").astype(np.int32)
    edges = np.concatenate([cut, domain[-1:]])
    return binned, edges


def _bin_discrete(col: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    col = col.astype(np.int64)
    known = col >= 0
    binned = np.full(col.shape, UNKNOWN, dtype=np.int32)
    n_values = int(col[known].max()) + 1 if known.any() else 0
    binned[known] = col[known].astype(np.int32)
    return binned, np.arange(n_values, dtype=np.float64)


def fit(
    columns: Sequence[np.ndarray],
    y: np.ndarray,
    *,
    attr_is_cont: Sequence[bool],
    n_classes: int | None = None,
    max_bins: int = 256,
    w: np.ndarray | None = None,
    attr_names: Sequence[str] = (),
) -> BinnedDataset:
    """Build the rank-space dataset from raw columns (YaDT stores by column).

    Discrete columns hold small non-negative integer codes (negative =
    unknown); continuous columns hold floats (NaN = unknown).
    """
    n = len(y)
    cols, edges = [], []
    for col, is_cont in zip(columns, attr_is_cont, strict=True):
        col = np.asarray(col)
        if col.shape != (n,):
            raise ValueError(f"column shape {col.shape} != ({n},)")
        b, e = _bin_continuous(col, max_bins) if is_cont else _bin_discrete(col)
        cols.append(b)
        edges.append(e)
    x = np.stack(cols, axis=1) if cols else np.zeros((n, 0), np.int32)
    y = np.asarray(y, dtype=np.int32)
    if n_classes is None:
        n_classes = int(y.max()) + 1 if n else 0
    w = np.ones(n, np.float32) if w is None else np.asarray(w, np.float32)
    return BinnedDataset(
        x=x, y=y, w=w,
        attr_is_cont=np.asarray(attr_is_cont, dtype=bool),
        n_bins=np.array([max(len(e), 1) for e in edges], dtype=np.int32),
        bin_edges=tuple(edges),
        n_classes=int(n_classes),
        attr_names=tuple(attr_names) or tuple(f"a{i}" for i in range(len(cols))),
    )


def from_binned(
    x: np.ndarray,
    y: np.ndarray,
    *,
    attr_is_cont: Sequence[bool],
    n_bins: Sequence[int],
    n_classes: int,
    w: np.ndarray | None = None,
) -> BinnedDataset:
    """Wrap already-binned integer data (used by tests / generators)."""
    x = np.asarray(x, dtype=np.int32)
    n_bins = np.asarray(n_bins, dtype=np.int32)
    edges = tuple(np.arange(int(b), dtype=np.float64) for b in n_bins)
    w = np.ones(len(y), np.float32) if w is None else np.asarray(w, np.float32)
    return BinnedDataset(
        x=x, y=np.asarray(y, np.int32), w=w,
        attr_is_cont=np.asarray(attr_is_cont, dtype=bool),
        n_bins=n_bins, bin_edges=edges, n_classes=int(n_classes),
        attr_names=tuple(f"a{i}" for i in range(x.shape[1])),
    )


def from_arrays(
    x: np.ndarray,
    y: np.ndarray,
    w: np.ndarray,
    attr_is_cont: Sequence[bool],
    n_bins: Sequence[int],
    bin_edges: Sequence[np.ndarray],
    n_classes: int,
) -> BinnedDataset:
    """Rebuild a dataset from the arrays of another package's
    ``BinnedDataset`` (the way a binned training set crosses over)."""
    x = np.asarray(x, dtype=np.int32)
    return BinnedDataset(
        x=x, y=np.asarray(y, np.int32), w=np.asarray(w, np.float32),
        attr_is_cont=np.asarray(attr_is_cont, dtype=bool),
        n_bins=np.asarray(n_bins, dtype=np.int32),
        bin_edges=tuple(np.asarray(e, np.float64) for e in bin_edges),
        n_classes=int(n_classes),
        attr_names=tuple(f"a{i}" for i in range(x.shape[1])),
    )
