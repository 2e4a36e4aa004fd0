"""Out-of-bag evaluation: generalisation error and variable importance.

Each bootstrap leaves ~36.8% of cases out of its tree's sample; those cases
are an honest test set *for that tree*.  Aggregating, every case is scored
by the sub-ensemble of trees that never saw it — the OOB estimate of
generalisation error, free with training (Breiman 1996).  Because the
bootstrap complements are pure functions of ``(seed, tree_id)``
(:mod:`.sampling`), OOB needs no state from the training run: any process
holding the trees and the config can recompute it.

Predictions go through the packed-forest batched path
(:func:`repro_torch.infer.forest.predict_per_tree`, the traversal kernel on
the card) — one ``(T, N)`` tensor on ``device`` — and the OOB-masked vote
is tallied there too: one ``scatter_add_`` a tree into an ``(N, C)`` count,
where the JAX package's ``_vote`` builds a ``(T, N, C)`` one-hot on the host
(1.28 GB at T = 16, N = 10M).  The counts are integers, so the vote is the
reference's exactly, ties to the lowest class included.

Permutation variable importance: re-score OOB accuracy with attribute
``a``'s column deterministically permuted; the accuracy drop is ``a``'s
importance.  Permutations are keyed by ``(seed, attr, repeat)``, so the
report is replayable too.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.binning import BinnedDataset
from repro_torch.core.device import resolve_device
from repro_torch.core.tree import Tree
from repro_torch.ensemble import sampling
from repro_torch.ensemble.trainer import ForestConfig
from repro_torch.infer.forest import Forest, predict_per_tree
from repro_torch.obs import metrics as obs_metrics


def oob_matrix(fc: ForestConfig, n_cases: int,
               tree_ids: list[int] | None = None) -> np.ndarray:
    """(T, N) bool: ``[t, i]`` = case i is out-of-bag for tree t."""
    ids = tree_ids if tree_ids is not None else list(range(fc.n_trees))
    return np.stack([
        sampling.bootstrap_counts(fc.seed, t, n_cases) == 0 for t in ids])


def _vote(per_tree: torch.Tensor, oob: torch.Tensor, n_classes: int
          ) -> torch.Tensor:
    """(N,) int32 OOB-masked majority vote of (T, N) classes under the
    (T, N) bool mask; -1 where no tree holds the case out."""
    t_dim, n = per_tree.shape
    tally = torch.zeros((n, n_classes), dtype=torch.int32,
                        device=per_tree.device)
    for t in range(t_dim):
        tally.scatter_add_(1, per_tree[t].long()[:, None],
                           oob[t].to(torch.int32)[:, None])
    pred = torch.argmax(tally, dim=-1).to(torch.int32)    # first maximum
    return torch.where(oob.any(dim=0), pred, -1).to(torch.int32)


def _accuracy(pred: torch.Tensor, y: torch.Tensor) -> tuple[float, int]:
    """(accuracy over the covered cases, their count); nan if none."""
    covered = pred >= 0
    n_cov, n_right = torch.stack([
        covered.sum(), (covered & (pred == y)).sum()]).tolist()
    return (n_right / n_cov if n_cov else float("nan")), n_cov


@dataclasses.dataclass(frozen=True)
class OOBResult:
    score: float            # accuracy over covered cases
    coverage: float         # fraction of cases with >= 1 OOB tree
    n_covered: int
    pred: torch.Tensor      # (N,) int32 OOB prediction, -1 = uncovered


def oob_score(trees: list[Tree], ds: BinnedDataset, fc: ForestConfig, *,
              tree_ids: list[int] | None = None, impl: str | None = None,
              device=None, metrics: obs_metrics.Registry | None = None,
              stats_out: dict | None = None) -> OOBResult:
    """OOB generalisation estimate of a trained forest, on ``device``
    (None: the card; raises without one).

    ``tree_ids`` names the ``(seed, tree_id)`` keys behind ``trees`` when
    they are not simply ``0..T-1`` (e.g. a non-strict chaos run that dropped
    a quarantined member).  ``impl`` is ``predict_per_tree``'s (None: the
    traversal kernel on the card, the plain version on the CPU).  Requires
    ``fc.bootstrap``; without resampling there is no out-of-bag complement.
    ``stats_out`` receives the seconds of packing the forest (``pack_s``),
    of the traversal with the rows' copy to the device (``predict_s``), of
    the mask (``mask_s``: drawn on the host, copied to the device) and of
    the vote (``vote_s``), each phase waited for on the device.
    """
    if not fc.bootstrap:
        raise ValueError("OOB is undefined without bootstrap resampling")
    if not trees:
        raise ValueError("OOB needs at least one tree")
    dev = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)
    t0 = time.perf_counter()
    forest = Forest.pack(trees, device=dev)
    sync()
    t_pack = time.perf_counter()
    per_tree = predict_per_tree(forest, ds.x, ds.attr_is_cont, impl=impl)
    sync()
    t1 = time.perf_counter()
    oob = oob_matrix(fc, ds.n_cases, tree_ids)
    if oob.shape[0] != len(trees):
        raise ValueError(f"{len(trees)} trees vs {oob.shape[0]} tree_ids")
    oob = torch.as_tensor(oob).to(dev)
    sync()
    t2 = time.perf_counter()
    pred = _vote(per_tree, oob, ds.n_classes)
    score, n_cov = _accuracy(pred, torch.as_tensor(ds.y).to(dev))
    t3 = time.perf_counter()
    if stats_out is not None:
        stats_out.update(pack_s=t_pack - t0, predict_s=t1 - t_pack,
                         mask_s=t2 - t1, vote_s=t3 - t2)
    reg = metrics if metrics is not None else obs_metrics.REGISTRY
    reg.gauge("ensemble_oob_score",
              "OOB accuracy of the last scored forest").set(score)
    reg.gauge("ensemble_oob_coverage",
              "fraction of cases with >= 1 OOB tree").set(
        n_cov / max(ds.n_cases, 1))
    return OOBResult(score=score, coverage=n_cov / max(ds.n_cases, 1),
                     n_covered=n_cov, pred=pred)


def permutation_importance(trees: list[Tree], ds: BinnedDataset,
                           fc: ForestConfig, *,
                           tree_ids: list[int] | None = None,
                           impl: str | None = None, device=None,
                           n_repeats: int = 1) -> np.ndarray:
    """(A,) mean OOB-accuracy drop when attribute ``a``'s column is permuted.

    Deterministic: permutation ``(a, r)`` is a pure function of
    ``(fc.seed, a, r)``.  Attributes the forest never splits on score ~0.
    """
    if n_repeats < 1:
        raise ValueError("n_repeats must be >= 1")
    dev = resolve_device(device)
    base = oob_score(trees, ds, fc, tree_ids=tree_ids, impl=impl,
                     device=dev, metrics=obs_metrics.Registry())
    forest = Forest.pack(trees, device=dev)
    oob = torch.as_tensor(oob_matrix(fc, ds.n_cases, tree_ids)).to(dev)
    x = torch.as_tensor(np.asarray(ds.x), dtype=torch.int32).to(dev)
    y = torch.as_tensor(ds.y).to(dev)
    imp = np.zeros((ds.n_attrs,), np.float64)
    for a in range(ds.n_attrs):
        drops = []
        for r in range(n_repeats):
            perm = torch.as_tensor(
                sampling.permutation(fc.seed, a, r, ds.n_cases)).to(dev)
            xp = x.clone()
            xp[:, a] = x[perm, a]
            per_tree = predict_per_tree(forest, xp, ds.attr_is_cont,
                                        impl=impl)
            acc, _ = _accuracy(_vote(per_tree, oob, ds.n_classes), y)
            drops.append(base.score - acc)
        imp[a] = float(np.mean(drops))
    return imp
