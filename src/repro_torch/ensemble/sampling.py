"""Deterministic per-tree bagging inputs: bootstrap weights + feature subsets.

Every randomised ingredient of a forest member is a *pure function* of
``(seed, tree_id)`` — the same content-addressed determinism discipline as
:mod:`repro.data.loader` (batch ``i`` is a pure function of ``(seed, step)``).
Nothing is sampled at dispatch time and no sampling state lives in the
trainer, so:

  * any farm worker can regenerate any tree's inputs after a crash — a
    retried tree task is bit-identical to its first attempt;
  * the forest does not depend on worker count, scheduling order or injected
    chaos: ``train_forest(n_workers=4, injector=...)`` equals the sequential
    per-tree oracle exactly;
  * the out-of-bag complement (:mod:`repro.ensemble.oob`) is recomputable
    anywhere from the same ``(seed, tree_id)`` key.

The bootstrap is expressed as *per-case weights* (draw counts times the
dataset's base weights) and the feature subset as a boolean *attribute
mask*, matching the ``case_w`` / ``attr_mask`` hooks on the growth engines
(:func:`repro.core.c45.build`, :func:`repro.core.frontier.build`) — per-tree
inputs never copy the dataset.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

#: Stream tags keeping the per-purpose PRNG streams disjoint for one seed.
TAG_BOOTSTRAP = 1
TAG_FEATURES = 2
TAG_PERMUTE = 3


def _rng(seed: int, tag: int, *key: int) -> np.random.Generator:
    """Content-addressed generator for one (seed, purpose, key) cell."""
    return np.random.default_rng((int(seed), int(tag), *map(int, key)))


def default_mtry(n_attrs: int) -> int:
    """Breiman's default feature-subset size: ceil(sqrt(A)), at least 1."""
    return max(1, int(math.ceil(math.sqrt(max(n_attrs, 0)))))


def bootstrap_counts(seed: int, tree_id: int, n_cases: int) -> np.ndarray:
    """(N,) int64 draw counts of the n-out-of-n bootstrap for one tree."""
    idx = _rng(seed, TAG_BOOTSTRAP, tree_id).integers(0, n_cases,
                                                      size=n_cases)
    return np.bincount(idx, minlength=n_cases).astype(np.int64)


def feature_mask(seed: int, tree_id: int, n_attrs: int,
                 mtry: int | None = None) -> np.ndarray:
    """(A,) bool mask with exactly ``mtry`` active attributes."""
    if mtry is None:
        mtry = default_mtry(n_attrs)
    if not 1 <= mtry <= n_attrs:
        raise ValueError(f"mtry={mtry} out of range [1, {n_attrs}]")
    mask = np.zeros((n_attrs,), dtype=bool)
    chosen = _rng(seed, TAG_FEATURES, tree_id).choice(n_attrs, size=mtry,
                                                      replace=False)
    mask[chosen] = True
    return mask


def permutation(seed: int, attr: int, repeat: int, n_cases: int) -> np.ndarray:
    """(N,) deterministic permutation for OOB variable importance."""
    return _rng(seed, TAG_PERMUTE, attr, repeat).permutation(n_cases)


@dataclasses.dataclass(frozen=True)
class TreeSample:
    """Everything tree ``tree_id`` needs beyond the shared dataset."""

    tree_id: int
    counts: np.ndarray      # int64 (N,) bootstrap draw counts (ones if off)
    case_w: np.ndarray      # f32 (N,) counts * base weights -> engine hook
    attr_mask: np.ndarray   # bool (A,) feature subset -> engine hook

    @property
    def oob(self) -> np.ndarray:
        """(N,) bool: cases *not* drawn by this tree's bootstrap."""
        return self.counts == 0


def draw(seed: int, tree_id: int, *, n_cases: int, n_attrs: int,
         base_w: np.ndarray | None = None, mtry: int | None = None,
         bootstrap: bool = True) -> TreeSample:
    """The per-tree sample: pure in ``(seed, tree_id)`` given the shapes."""
    counts = (bootstrap_counts(seed, tree_id, n_cases) if bootstrap
              else np.ones((n_cases,), np.int64))
    w = counts.astype(np.float32)
    if base_w is not None:
        w = w * np.asarray(base_w, np.float32)
    return TreeSample(tree_id=int(tree_id), counts=counts, case_w=w,
                      attr_mask=feature_mask(seed, tree_id, n_attrs, mtry))
