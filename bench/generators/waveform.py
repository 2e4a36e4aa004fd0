"""Breiman's waveform generator with 19 noise attributes (Waveform-40), on
the device from the seed.

A torch rewrite, frozen for the benchmark, of
``src/repro_torch/data/waveform.py`` as the commit that added this file
left it (itself Breiman, Friedman, Olshen and Stone, CART (1984), Sect.
2.6.2; the UCI "Waveform Database Generator (Version 2)"; MOA's
``WaveformGenerator -n``): three base waves over m = 1..21,

  h1(m) = max(6 - |m - 11|, 0),  h2(m) = h1(m - 4),  h3(m) = h1(m + 4),

a class uniform over three, and with u ~ U(0, 1), e_m ~ N(0, 1):

  class 0:  x_m = u h1(m) + (1 - u) h2(m) + e_m
  class 1:  x_m = u h1(m) + (1 - u) h3(m) + e_m
  class 2:  x_m = u h2(m) + (1 - u) h3(m) + e_m

then attributes 22..40 pure N(0, 1) noise.  Drawn by a ``torch.Generator``
on the device in float64, in the port's order (the classes, u, then the
columns in attribute order), a column at a time so that one float64 column
is live at once.  It repeats for a seed on one device and torch version;
it does not repeat the numpy stream of the port's copy.

The configuration file gives ``max_bins`` and ``n_cases``.
"""

from __future__ import annotations

import torch

from bench.binning import bin_continuous
from bench.dataset import Data, stack

N_WAVES, N_NOISE, N_CLASSES = 21, 19, 3
ATTRS = ([f"wave{m:02d}" for m in range(1, N_WAVES + 1)]
         + [f"noise{m}" for m in range(N_WAVES + 1, N_WAVES + N_NOISE + 1)])
# the two base waves each class mixes
CLASS_WAVES = ((0, 1), (0, 2), (1, 2))


def base_waves(device) -> torch.Tensor:
    """(3, 21) float64: h1, h2, h3 at m = 1..21."""
    m = torch.arange(1, N_WAVES + 1, dtype=torch.float64, device=device)

    def h1(v):
        return torch.clamp_min(6.0 - (v - 11.0).abs(), 0.0)
    return torch.stack([h1(m), h1(m - 4), h1(m + 4)])


def generate(config: dict, seed: int, device) -> Data:
    n = int(config["n_cases"])
    max_bins = int(config["max_bins"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(generator=g, device=device, dtype=torch.float64)

    y = torch.randint(0, N_CLASSES, (n,), generator=g, device=device)
    u = torch.rand(n, **f64)
    h = base_waves(device)
    pair = torch.tensor(CLASS_WAVES, device=device)[y]        # (n, 2)
    columns = []
    for j in range(N_WAVES):
        x = (u * h[pair[:, 0], j] + (1 - u) * h[pair[:, 1], j]
             + torch.randn(n, **f64))
        columns.append(bin_continuous(x, max_bins))
    for _ in range(N_NOISE):
        columns.append(bin_continuous(torch.randn(n, **f64), max_bins))
    return stack(columns, y, attr_is_cont=[True] * len(columns),
                 n_classes=N_CLASSES, attr_names=ATTRS)
