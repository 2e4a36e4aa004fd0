"""Schema-matched stand-ins for the paper's Table 1 training sets.

The four UCI datasets are not redistributable inside this offline container,
so each is replaced by a synthetic dataset with the *same schema* (cases,
classes, discrete/continuous attribute counts) and a learnable structure: a
random ground-truth decision tree over the schema labels the cases, plus
label noise — giving induced trees of realistic size/depth for the
scheduling benchmarks (what the paper's figures measure is farm dynamics
over the task DAG, which depends on the tree shape, not on UCI semantics).

``load(name, scale=...)`` subsamples the case count for CPU-budget runs;
benchmarks record the scale they used.  ``load`` also makes the
deployments of ``GENERATED``, which are stated generators rather than
stand-ins for a Table 1 file: Waveform-40 (``data/waveform.py``) and
Poker-Hand (``data/pokerhand.py``), each by its own generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.binning import BinnedDataset, fit
from repro_torch.data import pokerhand, quest, waveform


@dataclasses.dataclass(frozen=True)
class TableOneSpec:
    name: str
    n_cases: int
    n_classes: int
    n_discrete: int
    n_continuous: int
    tree_size: int      # as reported in paper Table 1 (for reference)
    tree_depth: int


TABLE1: dict[str, TableOneSpec] = {
    "census_pums": TableOneSpec("Census PUMS", 299_285, 2, 33, 7,
                                122_306, 31),
    "us_census": TableOneSpec("U.S. Census", 2_458_285, 5, 67, 0,
                              125_621, 44),
    "kddcup99": TableOneSpec("KDD Cup 99", 4_898_431, 23, 7, 34, 2_810, 29),
    "forest_cover": TableOneSpec("Forest Cover", 581_012, 7, 44, 10,
                                 41_775, 62),
    "syd10m9a": TableOneSpec("SyD10M9A", 10_000_000, 2, 3, 6, 169_108, 22),
}

# Deployments beside Table 1's, each a stated generator at Table 1's
# largest scale: name -> (full case count, its generator's ``generate``).
# Waveform-40: data/waveform.py; Poker-Hand: data/pokerhand.py.
GENERATED = {"waveform40": (10_000_000, waveform.generate),
             "pokerhand10m": (10_000_000, pokerhand.generate)}


def _random_tree_labels(x_cols: list[np.ndarray], is_cont: list[bool],
                        n_classes: int, rng: np.random.Generator,
                        depth: int = 12, noise: float = 0.08) -> np.ndarray:
    """Label cases by a random ground-truth tree over the given columns."""
    n = len(x_cols[0])
    y = np.zeros(n, np.int32)

    def grow(idx: np.ndarray, d: int) -> None:
        if d == 0 or len(idx) < 64:
            y[idx] = rng.integers(0, n_classes)
            return
        a = int(rng.integers(0, len(x_cols)))
        col = x_cols[a][idx]
        if is_cont[a]:
            thr = np.quantile(col, rng.uniform(0.25, 0.75))
            left = col <= thr
        else:
            vals = np.unique(col)
            pick = rng.choice(vals, size=max(1, len(vals) // 2),
                              replace=False)
            left = np.isin(col, pick)
        if left.all() or not left.any():
            y[idx] = rng.integers(0, n_classes)
            return
        grow(idx[left], d - 1)
        grow(idx[~left], d - 1)

    grow(np.arange(n), depth)
    flip = rng.random(n) < noise
    y[flip] = rng.integers(0, n_classes, int(flip.sum()))
    return y


def load(name: str, *, scale: float = 1.0, seed: int = 0,
         max_bins: int = 128) -> BinnedDataset:
    """Materialise a Table-1 stand-in, or a deployment of ``GENERATED``, at
    ``scale`` of its full size."""
    if name in GENERATED:
        n_cases, generate = GENERATED[name]
        return generate(max(256, int(n_cases * scale)), seed=seed,
                        max_bins=max_bins)
    spec = TABLE1[name]
    n = max(256, int(spec.n_cases * scale))
    if name == "syd10m9a":
        return quest.generate(n, function=5, seed=seed, max_bins=max_bins)

    import zlib
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (1 << 16))
    cols: list[np.ndarray] = []
    kinds: list[bool] = []
    for _ in range(spec.n_continuous):
        loc, sc = rng.uniform(-5, 5), rng.uniform(0.5, 3.0)
        cols.append(rng.normal(loc, sc, n))
        kinds.append(True)
    for _ in range(spec.n_discrete):
        h = int(rng.integers(2, 12))
        cols.append(rng.integers(0, h, n))
        kinds.append(False)
    y = _random_tree_labels(cols, kinds, spec.n_classes, rng)
    return fit(cols, y, attr_is_cont=kinds, n_classes=spec.n_classes,
               max_bins=max_bins)
