"""Breiman's waveform generator with noise attributes (Waveform-40).

Breiman, Friedman, Olshen and Stone, *Classification and Regression Trees*
(1984), Sect. 2.6.2; the UCI "Waveform Database Generator (Version 2)";
MOA's ``WaveformGenerator`` with ``-n`` (the same three classes under
other labels).  Three base waves over m = 1..21:

  h1(m) = max(6 - |m - 11|, 0),  h2(m) = h1(m - 4),  h3(m) = h1(m + 4)

The class is uniform over three; with u ~ U(0, 1) and e_m ~ N(0, 1) a
case's wave attributes are

  class 0:  x_m = u h1(m) + (1 - u) h2(m) + e_m
  class 1:  x_m = u h1(m) + (1 - u) h3(m) + e_m
  class 2:  x_m = u h2(m) + (1 - u) h3(m) + e_m

and attributes 22..40 are pure N(0, 1) noise: 40 continuous attributes,
3 classes, a Bayes error near 14%.  Draw order: the classes, u, then the
40 columns in attribute order.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.binning import BinnedDataset, fit

N_WAVES = 21
N_NOISE = 19
N_CLASSES = 3
ATTR_NAMES = (tuple(f"wave{m:02d}" for m in range(1, N_WAVES + 1))
              + tuple(f"noise{m}" for m in range(N_WAVES + 1,
                                                 N_WAVES + N_NOISE + 1)))
# the two base waves (indices into base_waves()) each class mixes
CLASS_WAVES = ((0, 1), (0, 2), (1, 2))


def base_waves() -> np.ndarray:
    """(3, 21) float64: h1, h2, h3 at m = 1..21."""
    m = np.arange(1, N_WAVES + 1, dtype=np.float64)

    def h1(v):
        return np.maximum(6.0 - np.abs(v - 11.0), 0.0)
    return np.stack([h1(m), h1(m - 4), h1(m + 4)])


def generate(n: int, *, seed: int = 0, max_bins: int = 256
             ) -> BinnedDataset:
    """``n`` cases of Waveform-40 in rank space."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, N_CLASSES, n)
    u = rng.random(n)
    h = base_waves()
    first = h[[a for a, _ in CLASS_WAVES]][y]          # (n, 21)
    second = h[[b for _, b in CLASS_WAVES]][y]
    columns = [u * first[:, j] + (1 - u) * second[:, j]
               + rng.standard_normal(n) for j in range(N_WAVES)]
    columns += [rng.standard_normal(n) for _ in range(N_NOISE)]
    return fit(columns, y, attr_is_cont=[True] * len(columns),
               n_classes=N_CLASSES, max_bins=max_bins,
               attr_names=ATTR_NAMES)
