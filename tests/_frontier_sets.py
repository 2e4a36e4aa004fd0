"""Binned data sets the frontier tests walk, beside the bundled ones, and
their tensors: a helper of the CPU tests and the card tests alike."""

import numpy as np
import pytest
import torch

from repro_torch.core import binning


def as_tensors(ds, device=None):
    """``(x, y, w, attr_is_cont, n_bins)`` of a binned data set, as the
    frontier's phases take them."""
    return (torch.as_tensor(ds.x, dtype=torch.int32, device=device),
            torch.as_tensor(ds.y, dtype=torch.int32, device=device),
            torch.as_tensor(ds.w, dtype=torch.float32, device=device),
            torch.as_tensor(ds.attr_is_cont, device=device),
            torch.as_tensor(ds.n_bins, dtype=torch.int32, device=device))


@pytest.fixture
def one_thread():
    """torch's CPU ops on one thread for the test (import the fixture,
    then ``@pytest.mark.usefixtures("one_thread")``).  The plain path
    scores whole (K, A, B, C) histograms a superstep; on every core of the
    host, in each of the suite's parallel workers at once, those ops spend
    their time at OpenMP barriers: on 8 cores, the KDD-like walk of 1,000
    cases took 2.8 s alone and 527 s in each of six such processes at
    once, 14 s on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def kdd_like(n, seed):
    """A KDD-like data set: 41 attributes (34 continuous of 64 bins, 5%
    unknown; 7 discrete of 3-70 values), 23 classes; the labels follow a
    few attributes, with noise."""
    rng = np.random.default_rng(seed)
    cards = (3, 70, 11, 2, 40, 5, 23)
    cont = rng.integers(0, 64, (n, 34))
    cont[rng.random((n, 34)) < 0.05] = -1
    disc = np.stack([rng.integers(0, c, n) for c in cards], 1)
    y = (disc[:, 1] + cont[:, 0] // 8 + disc[:, 5] * 3) % 23
    y = np.where(rng.random(n) < 0.1, rng.integers(0, 23, n), y)
    return binning.from_binned(
        np.concatenate([cont, disc], 1), y,
        attr_is_cont=[True] * 34 + [False] * 7, n_bins=[64] * 34 + list(cards),
        n_classes=23)
