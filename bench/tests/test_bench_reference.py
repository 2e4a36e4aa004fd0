"""The plain reference: a hand-checked tree, the port's tree on small
copies of each configuration, and its rule for near ties."""

import dataclasses

import numpy as np
import pytest
import torch

from bench import reference
from bench.tests import _small

GROW = dict(max_nodes=64, frontier_slots=256, min_objs=1.0, max_depth=64,
            criterion="gain")


def _grow(x, y, n_bins, is_cont, **over):
    return reference.grow(torch.tensor(x, dtype=torch.int32).T.contiguous(),
                          torch.tensor(y), n_bins=n_bins,
                          attr_is_cont=is_cont, n_classes=2,
                          grow=reference.Grow.of({**GROW, **over}))


# eight cases: a continuous attribute that separates the classes at bin 1,
# and a discrete one of three values that does not
X = [[0, 0, 1, 1, 2, 2, 3, 3], [0, 1, 2, 0, 1, 2, 0, 1]]
Y = [0, 0, 0, 0, 1, 1, 1, 1]


def test_hand_checked_tree():
    r = _grow(X, Y, [4, 3], [True, False])
    # the root splits on attribute 0 at bin 1 (gain 1 bit, against the
    # discrete split's 1 - (3 * 0.918 + 3 * 0.918 + 2) / 8 = 0.061); both
    # children are pure leaves; the root's 4/4 tie takes class 0
    assert r.n_nodes == 3 and not r.overflow
    t = r.tree
    assert t["node_attr"].tolist() == [0, -1, -1]
    assert t["node_split_bin"].tolist() == [1, -1, -1]
    assert t["node_child0"].tolist() == [1, 0, 0]
    assert t["node_nchild"].tolist() == [2, 0, 0]
    assert t["node_class"].tolist() == [0, 0, 1]
    assert t["node_freq"].tolist() == [[4, 4], [4, 0], [0, 4]]
    assert t["node_depth"].tolist() == [0, 1, 1]


def test_hand_checked_discrete_split_and_capacity():
    # the class follows the discrete attribute: values 0, 1 -> 0, value 2 -> 1
    y = [0, 0, 1, 0, 0, 1, 0, 0]
    r = _grow([[0] * 8, X[1]], y, [1, 3], [True, False])
    assert r.tree["node_attr"].tolist() == [1, -1, -1, -1]
    assert r.tree["node_nchild"].tolist()[0] == 3
    assert r.tree["node_freq"].tolist() == [[6, 2], [3, 0], [3, 0], [0, 2]]
    # two nodes of capacity: the root's batch would pass it, so it stays a
    # leaf
    r = _grow(X, Y, [4, 3], [True, False], max_nodes=2)
    assert r.n_nodes == 1 and r.overflow


@pytest.mark.parametrize("name,n,seed,over,classes", [
    ("syd10m9a", 20000, 5, {}, 2),
    ("syd10m9a", 20000, 2**31 + 5, {"max_depth": 6}, 2),
    ("syd10m9a", 20000, 6, {"max_nodes": 700}, 2),
    ("syd10m9a", 5000, 7, {}, 5),
])
def test_equals_the_ports_tree(name, n, seed, over, classes):
    cfg, d = _small.data(name, n, seed)
    if classes > 2:
        # more classes, the general scorer's path: the class spread by
        # the discrete attribute car
        d = dataclasses.replace(d, y=d.y + 2 * (d.x[:, 7].long() % 2)
                                + (d.x[:, 7].long() == 3), n_classes=classes)
    grow = {**cfg["grow"], **over}
    port = _small.port_tree(d, grow)
    # without the port's tree: no near tie to settle
    r = _small.oracle(d, grow)
    assert reference.compare(port, r.tree) == 0
    assert r.n_nodes == len(port["node_attr"]) > 100


def test_near_tie_takes_the_tested_split_and_nothing_else():
    # attributes 0 and 2 are the same column: their splits tie exactly
    x = [X[0], X[1], X[0]]
    r = _grow(x, Y, [4, 3, 4], [True, False, True])
    assert r.tree["node_attr"][0] == 0
    tested = {k: v.copy() for k, v in r.tree.items()}
    tested["node_attr"][0] = 2
    again = reference.grow(
        torch.tensor(x, dtype=torch.int32).T.contiguous(), torch.tensor(Y),
        n_bins=[4, 3, 4], attr_is_cont=[True, False, True], n_classes=2,
        grow=reference.Grow.of(GROW), tested=tested)
    assert again.near_ties == 1
    assert reference.compare(tested, again.tree) == 0
    # a worse split is no tie: the discrete attribute at the root
    worse = {k: v.copy() for k, v in r.tree.items()}
    worse["node_attr"][0] = 1
    worse["node_split_bin"][0] = -1
    again = reference.grow(
        torch.tensor(x, dtype=torch.int32).T.contiguous(), torch.tensor(Y),
        n_bins=[4, 3, 4], attr_is_cont=[True, False, True], n_classes=2,
        grow=reference.Grow.of(GROW), tested=worse)
    assert again.near_ties == 0
    assert reference.compare(worse, again.tree) > 0


def test_tie_tolerance_is_float32_rounding():
    tol = reference.tie_tolerance(np.array([4.0, 1e7]), 2, 20)
    assert 1e-6 < tol[0] < tol[1] < 2e-4


def test_compare_counts_nodes():
    t = {f: np.zeros(5, np.int64) for f in reference.FIELDS}
    t["node_freq"] = np.zeros((5, 2))
    u = {k: v.copy() for k, v in t.items()}
    assert reference.compare(t, u) == 0
    u["node_freq"][3, 1] = 1
    u["node_class"][1] = 1
    assert reference.compare(t, u) == 2
    assert reference.compare(t, {k: v[:3] for k, v in t.items()}) == 2
