"""Poker-Hand through the port: both labelers (the port's
``data/pokerhand.py`` and the benchmark's frozen
``bench/generators/pokerhand.py``) give each hand its poker rank, the
generators draw the stated class shares, and the port's frontier build
grows the tree of the benchmark's plain reference (``bench/reference.py``)
on the frozen generator's data: 10 classes, 4-way suit splits and 13-bin
ranks.  On the card, ``impl="cuda"`` grows the tree of ``impl="torch"``."""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from _frontier_sets import one_thread  # noqa: E402,F401
from bench import harness, reference, spec  # noqa: E402
from repro_torch.core import frontier  # noqa: E402
from repro_torch.core.config import GrowConfig  # noqa: E402
from repro_torch.core.tree import trees_equal  # noqa: E402
from repro_torch.data import datasets, pokerhand, waveform  # noqa: E402

FROZEN = spec.generator("pokerhand")


def _frozen(n: int, seed: int):
    cfg = spec.config("pokerhand10m")
    cfg["n_cases"] = n
    return cfg, FROZEN.generate(cfg, seed, "cpu")


# (cases, node capacity): the 2,048 cap is hit at 20k cases; at 3k cases
# the tree ends on its own.
@pytest.mark.parametrize("n,cap", [(20_000, 2_048), (3_000, 1 << 18)])
@pytest.mark.parametrize("seed", (0, 7, 2**31 + 9))
@pytest.mark.usefixtures("one_thread")
def test_port_grows_the_reference_tree(n, cap, seed):
    cfg, d = _frozen(n, seed)
    grow = {**cfg["grow"], "max_nodes": cap}
    tested = harness.host_tree(
        harness.port_builder(grow, "cpu")(harness.dataset(d)))
    ref = reference.grow(d.x, d.y, n_bins=d.n_bins,
                         attr_is_cont=d.attr_is_cont, n_classes=10,
                         grow=reference.Grow.of(grow), tested=tested)
    assert ref.overflow == (cap < 1 << 18)
    assert ref.n_nodes > 1000
    # suit splits open one child a suit
    splits = tested["node_attr"] >= 0
    suit = splits & ~np.asarray(d.attr_is_cont)[tested["node_attr"]]
    assert suit.any() and (tested["node_nchild"][suit] == 4).all()
    assert reference.compare(tested, ref.tree) == 0


# (suit, rank) of each card; suits 0-3, ranks 1-13 (Ace = 1)
HANDS = {
    "nothing": ([(0, 2), (1, 5), (2, 9), (3, 11), (0, 13)], 0),
    "one pair": ([(0, 7), (1, 7), (2, 2), (3, 12), (0, 4)], 1),
    "two pairs": ([(0, 7), (1, 7), (2, 12), (3, 12), (0, 4)], 2),
    "three of a kind": ([(0, 9), (1, 9), (2, 9), (3, 1), (0, 4)], 3),
    "ace-low straight": ([(0, 3), (1, 1), (2, 5), (3, 2), (0, 4)], 4),
    "ace-high straight": ([(0, 12), (1, 1), (2, 10), (3, 13), (0, 11)], 4),
    "no wrap past the king": ([(0, 12), (1, 13), (2, 1), (3, 2), (0, 3)], 0),
    "flush": ([(2, 2), (2, 5), (2, 9), (2, 11), (2, 13)], 5),
    "full house": ([(0, 6), (1, 6), (2, 13), (3, 6), (0, 13)], 6),
    "four of a kind": ([(0, 8), (1, 8), (2, 8), (3, 8), (0, 1)], 7),
    "straight flush": ([(3, 9), (3, 7), (3, 8), (3, 5), (3, 6)], 8),
    "ace-low straight flush": ([(1, 1), (1, 2), (1, 3), (1, 4), (1, 5)], 8),
    "royal flush": ([(1, 13), (1, 10), (1, 1), (1, 12), (1, 11)], 9),
}


@pytest.mark.parametrize("name", HANDS)
def test_label_on_written_hands(name):
    cards, want = HANDS[name]
    suits = np.array([[s for s, _ in cards]])
    ranks = np.array([[r for _, r in cards]])
    assert pokerhand.label(suits, ranks).tolist() == [want]
    assert FROZEN.label(torch.as_tensor(suits),
                        torch.as_tensor(ranks)).tolist() == [want]


def test_labelers_agree_over_every_hand():
    cards = np.array(list(itertools.combinations(range(52), 5)))
    suits, ranks = cards // 13, cards % 13 + 1
    port = pokerhand.label(suits, ranks)
    frozen = FROZEN.label(torch.as_tensor(suits), torch.as_tensor(ranks))
    np.testing.assert_array_equal(port, frozen.numpy())
    assert tuple(np.bincount(port, minlength=10)) == pokerhand.EXACT_COUNTS
    assert sum(pokerhand.EXACT_COUNTS) == len(cards) == 2_598_960


def _shares(y) -> np.ndarray:
    return np.bincount(np.asarray(y), minlength=10) / len(y)


@pytest.mark.parametrize("side", ("port", "frozen"))
def test_class_shares_at_200k(side):
    n = 200_000
    if side == "port":
        y = datasets.load("pokerhand10m", scale=n / 10_000_000, seed=5,
                          max_bins=256).y
    else:
        y = _frozen(n, 5)[1].y.numpy()
    exact = np.array(pokerhand.EXACT_COUNTS) / 2_598_960
    np.testing.assert_allclose(_shares(y)[:4], exact[:4], atol=0.005)
    assert (_shares(y)[:8] > 0).all()


def test_port_generator_keeps_the_schema():
    n = 50_000
    ds = datasets.load("pokerhand10m", scale=n / 10_000_000, seed=3,
                       max_bins=256)
    assert ds.n_cases == n and ds.n_attrs == 10 and ds.n_classes == 10
    assert ds.attr_names == pokerhand.ATTR_NAMES
    assert ds.attr_names[:3] == ("S1", "C1", "S2")
    assert ds.attr_is_cont.tolist() == [False, True] * 5
    assert ds.n_bins.tolist() == [4, 13] * 5
    # ranks in exact rank space: bin b is rank b + 1
    np.testing.assert_array_equal(ds.bin_edges[1], np.arange(1, 14))
    # the generator's draws again from the same seed: five distinct cards
    suits, ranks = pokerhand.draw(n, np.random.default_rng(3))
    np.testing.assert_array_equal(ds.x[:, 0::2], suits)
    np.testing.assert_array_equal(ds.x[:, 1::2] + 1, ranks)
    card = suits * 13 + ranks - 1
    assert (np.sort(card, axis=1)[:, 1:] != np.sort(card, axis=1)[:, :-1]
            ).all()
    np.testing.assert_array_equal(ds.y, pokerhand.label(suits, ranks))


def test_frozen_generator_draws_distinct_cards_in_uci_order():
    _, d = _frozen(20_000, 2**31 + 1)
    assert d.attr_names == list(pokerhand.ATTR_NAMES)
    assert d.attr_is_cont == [False, True] * 5 and d.n_bins == [4, 13] * 5
    card = d.x[:, 0::2] * 13 + d.x[:, 1::2]
    assert (card.sort(dim=1).values.diff(dim=1) != 0).all()
    assert torch.equal(d.y, FROZEN.label(d.x[:, 0::2], d.x[:, 1::2] + 1))


def test_load_still_gives_waveform40():
    ds = datasets.load("waveform40", scale=3e-4, seed=4, max_bins=256)
    want = waveform.generate(ds.n_cases, seed=4, max_bins=256)
    assert ds.n_cases in (2_999, 3_000)
    assert ds.attr_names == waveform.ATTR_NAMES and ds.n_classes == 3
    np.testing.assert_array_equal(ds.x, want.x)
    np.testing.assert_array_equal(ds.y, want.y)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_build_equals_torch_build(cuda_device):
    ds = datasets.load("pokerhand10m", scale=0.02, seed=1, max_bins=256)
    cfg = GrowConfig(max_nodes=1 << 15, frontier_slots=256)
    a = frontier.build(ds, cfg, impl="cuda", device=cuda_device)
    b = frontier.build(ds, cfg, impl="torch", device=cuda_device)
    assert int(a.n_nodes) > 1000
    assert trees_equal(a, b)
