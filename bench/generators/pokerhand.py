"""Poker hands (UCI Poker Hand, Cattral and Oppacher 2007), on the device
from the seed.

A torch rewrite, frozen for the benchmark, of
``src/repro_torch/data/pokerhand.py`` as the commit that added this file
left it.  A case is the first five cards of a uniform permutation of a
52-card deck, in the order drawn; its attributes, in UCI order, are S1,
C1, ..., S5, C5: Si the suit of card i, discrete with 4 values (UCI's 1-4,
coded 0-3), Ci its rank, continuous, 1-13 (Ace = 1 ... King = 13).  The
class is the hand's poker rank:

  0 nothing          1 one pair         2 two pairs       3 three of a kind
  4 straight         5 flush            6 full house      7 four of a kind
  8 straight flush   9 royal flush

a straight being five distinct consecutive ranks, A-2-3-4-5 and
10-J-Q-K-A both counted, and a royal flush 10-J-Q-K-A of one suit (not
counted as a straight flush).  Of the 2,598,960 hands the classes hold
exactly 1,302,540; 1,098,240; 123,552; 54,912; 10,200; 5,108; 3,744; 624;
36 and 4.

Drawn by a ``torch.Generator`` on the device: for each chunk of hands one
float64 key a card a hand, the hand being the five cards of smallest key
in key order.  A chunk holds ``CHUNK`` hands, so that the keys of 10M
hands (4 GB) are never on the card at once.  It repeats for a seed on one
device and torch version; it does not repeat the numpy stream of the
port's copy.

The configuration file gives ``max_bins`` and ``n_cases``.
"""

from __future__ import annotations

import torch

from bench.binning import bin_continuous, bin_discrete
from bench.dataset import Data, stack

N_CLASSES, N_SUITS, N_RANKS, HAND = 10, 4, 13, 5
ATTRS = [f"{kind}{i}" for i in range(1, HAND + 1) for kind in ("S", "C")]
ROYAL = (1, 10, 11, 12, 13)
CHUNK = 1 << 20


def label(suits: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """The poker rank (0-9) of each hand of (n, 5) suits and ranks 1-13."""
    r = torch.sort(ranks, dim=1).values
    flush = (suits == suits[:, :1]).all(dim=1)
    most = (r[:, :, None] == r[:, None, :]).sum(dim=2).amax(dim=1)
    distinct = 1 + (r.diff(dim=1) != 0).sum(dim=1)
    royal = (r == torch.tensor(ROYAL, device=r.device)).all(dim=1)
    straight = (distinct == 5) & ((r[:, 4] - r[:, 0] == 4) | royal)
    y = torch.zeros(r.shape[0], dtype=torch.int64, device=r.device)
    # the lowest rank first, each later rule over the ones before it
    for cls, hit in ((1, distinct == 4), (2, distinct == 3), (3, most == 3),
                     (4, straight), (5, flush),
                     (6, (most == 3) & (distinct == 2)), (7, most == 4),
                     (8, straight & flush), (9, royal & flush)):
        y = torch.where(hit, cls, y)
    return y


def generate(config: dict, seed: int, device) -> Data:
    n = int(config["n_cases"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    cards = torch.empty((n, HAND), dtype=torch.int64, device=device)
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        keys = torch.rand((m, N_SUITS * N_RANKS), generator=g,
                          device=device, dtype=torch.float64)
        cards[lo:lo + m] = keys.topk(HAND, dim=1, largest=False).indices
        del keys
    suits, ranks = cards // N_RANKS, cards % N_RANKS + 1
    y = label(suits, ranks)
    max_bins = int(config["max_bins"])
    columns = []
    for i in range(HAND):
        columns.append(bin_discrete(suits[:, i]))
        columns.append(bin_continuous(ranks[:, i].to(torch.float64),
                                      max_bins))
    return stack(columns, y, attr_is_cont=[a[0] == "C" for a in ATTRS],
                 n_classes=N_CLASSES, attr_names=ATTRS)
