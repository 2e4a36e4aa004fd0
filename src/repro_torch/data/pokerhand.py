"""Poker hands: five cards drawn from a 52-card deck, labelled by the hand's
poker rank (the UCI "Poker Hand" data set, Cattral and Oppacher, 2007).

A case is the first five cards of a uniform permutation of the deck, in
the order drawn.  Its attributes, in UCI order, are S1, C1, ..., S5, C5:

  Si  the suit of card i, discrete with 4 values (UCI's 1-4, Hearts,
      Spades, Diamonds, Clubs, coded 0-3 here);
  Ci  the rank of card i, continuous, 1-13 (Ace = 1 ... King = 13).

The class is the hand's poker rank, 10 classes:

  0 nothing          1 one pair         2 two pairs       3 three of a kind
  4 straight         5 flush            6 full house      7 four of a kind
  8 straight flush   9 royal flush

A straight is five distinct consecutive ranks, A-2-3-4-5 and 10-J-Q-K-A
both counted; a royal flush is 10-J-Q-K-A of one suit and is not counted
as a straight flush.  Over the 2,598,960 hands the classes hold exactly
``EXACT_COUNTS``.  Draw order: for each chunk of hands, one uniform key a
card of the deck a hand; a hand's cards are the five with the smallest
keys, in key order.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.binning import BinnedDataset, fit

N_CLASSES = 10
N_SUITS, N_RANKS, HAND = 4, 13, 5
ATTR_NAMES = tuple(f"{kind}{i}" for i in range(1, HAND + 1)
                   for kind in ("S", "C"))
ATTR_IS_CONT = tuple(name[0] == "C" for name in ATTR_NAMES)
# hands of each class among the C(52, 5) = 2,598,960
EXACT_COUNTS = (1_302_540, 1_098_240, 123_552, 54_912, 10_200, 5_108,
                3_744, 624, 36, 4)
ROYAL = (1, 10, 11, 12, 13)
# hands drawn at once: a chunk's keys are CHUNK x 52 float64
CHUNK = 1 << 20


def label(suits: np.ndarray, ranks: np.ndarray) -> np.ndarray:
    """The poker rank (0-9) of each hand: ``suits`` and ``ranks`` are (n, 5)
    integer arrays, suits in any four codes, ranks 1-13."""
    suits, ranks = np.asarray(suits), np.asarray(ranks)
    r = np.sort(ranks, axis=1)
    flush = (suits == suits[:, :1]).all(axis=1)
    # cards sharing each card's rank, and the number of distinct ranks
    same = (r[:, :, None] == r[:, None, :]).sum(axis=2)
    most = same.max(axis=1)
    distinct = 1 + (np.diff(r, axis=1) != 0).sum(axis=1)
    royal = (r == np.asarray(ROYAL)).all(axis=1)
    straight = (distinct == 5) & ((r[:, 4] - r[:, 0] == 4) | royal)
    y = np.select(
        [royal & flush, straight & flush, most == 4,
         (most == 3) & (distinct == 2), flush, straight, most == 3,
         distinct == 3, distinct == 4],
        [9, 8, 7, 6, 5, 4, 3, 2, 1], default=0)
    return y.astype(np.int32)


def draw(n: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """(suits 0-3, ranks 1-13), each (n, 5), of ``n`` hands."""
    cards = np.empty((n, HAND), np.int64)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        keys = rng.random((m, N_SUITS * N_RANKS))
        cards[lo:lo + m] = np.argsort(keys, axis=1, kind="stable")[:, :HAND]
    return cards // N_RANKS, cards % N_RANKS + 1


def generate(n: int, *, seed: int = 0, max_bins: int = 256
             ) -> BinnedDataset:
    """``n`` poker hands in rank space."""
    suits, ranks = draw(n, np.random.default_rng(seed))
    columns = [c for i in range(HAND) for c in (suits[:, i], ranks[:, i])]
    return fit(columns, label(suits, ranks), attr_is_cont=ATTR_IS_CONT,
               n_classes=N_CLASSES, max_bins=max_bins,
               attr_names=ATTR_NAMES)
