"""The torch Tree (repro_torch.core.tree) against the JAX Tree.

Trees built by the JAX engines cross over with ``tree_from_numpy`` and back
with ``Tree.to_numpy``; heavy-child routing, prediction and ``trees_equal``
must agree exactly (integer outputs, no tolerance).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_tree_dataset
from repro.core import binning, c45
from repro.core import tree as jt
from repro.core.config import GrowConfig
from repro_torch.core import tree as tt


def _to_torch(jax_tree) -> tt.Tree:
    return tt.tree_from_numpy(vars(jax_tree.to_numpy()), "cpu")


def _chain_fields(depth: int) -> dict:
    """Right-leaning chain: internal at every level, the deepest leaf
    classifies 1 (the depth-over-64 case of tests/test_tree_predict.py)."""
    n = 2 * depth + 1
    f = dict(node_attr=np.full(n, -1, np.int32),
             node_split_bin=np.full(n, -1, np.int32),
             node_child0=np.zeros(n, np.int32),
             node_nchild=np.zeros(n, np.int32),
             node_class=np.zeros(n, np.int32),
             node_freq=np.zeros((n, 2), np.float32),
             node_depth=np.zeros(n, np.int32), n_nodes=np.int32(n))
    node = 0
    for d in range(depth):
        f["node_attr"][node] = 0
        f["node_split_bin"][node] = 0
        f["node_child0"][node] = node + 1
        f["node_nchild"][node] = 2
        f["node_depth"][node + 1] = f["node_depth"][node + 2] = d + 1
        f["node_freq"][node + 1] = [1.0, 0.0]
        f["node_freq"][node + 2] = [0.0, 2.0]
        node += 2
    f["node_class"][node] = 1
    f["node_freq"][0] = [1.0, 2.0]
    return f


def _wide_dataset(heavy_value: int, n_values: int = 12):
    xs, ys = [], []
    for v in range(n_values):
        reps = 4 + (30 if v == heavy_value else 0)
        xs += [v] * reps
        ys += [v % 2 if v != heavy_value else 1] * reps
    return binning.fit([np.array(xs)], np.array(ys), attr_is_cont=[False],
                       n_classes=2)


def test_round_trip_and_properties(rng):
    ds = make_tree_dataset(rng, 300, n_cont=2, n_disc=2, unknown_frac=0.1)
    jtree = c45.build(ds, GrowConfig(), capacity=1024)
    t = _to_torch(jtree)
    assert isinstance(t.node_attr, torch.Tensor)
    assert t.node_freq.dtype == torch.float32
    back = t.to_numpy()
    for f in tt.FIELDS:
        np.testing.assert_array_equal(getattr(back, f),
                                      np.asarray(getattr(jtree, f)))
    assert (t.size, t.depth, t.n_leaves) == (jtree.size, jtree.depth,
                                             jtree.n_leaves)
    assert t.pretty() == jtree.pretty()
    empty = tt.Tree.empty(8, 3, device="cpu")
    jempty = jt.Tree.empty(8, 3)
    for f in tt.FIELDS:
        np.testing.assert_array_equal(getattr(empty.to_numpy(), f),
                                      np.asarray(getattr(jempty, f)))


def test_heavy_child_table_random_wide_trees(rng):
    for _ in range(5):
        m = 64
        nchild = np.zeros(m, np.int32)
        child0 = np.zeros(m, np.int32)
        nxt, emit = 1, 0
        while nxt < m - 1:
            width = min(int(rng.integers(2, 14)), m - nxt)
            if width < 2:
                break
            nchild[emit], child0[emit] = width, nxt
            nxt += width
            emit += 1
        freq = rng.random((m, 3)).astype(np.float32)
        want = np.asarray(jt.heavy_child_table(child0, nchild, freq))
        got = tt.heavy_child_table(torch.as_tensor(child0),
                                   torch.as_tensor(nchild),
                                   torch.as_tensor(freq))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("heavy", [1, 10, 11])
def test_wide_split_unknown_routes_to_heavy_child(heavy):
    ds = _wide_dataset(heavy)
    jtree = c45.build(ds, GrowConfig(min_objs=1.0))
    t = _to_torch(jtree)
    assert int(t.node_nchild[0]) == 12
    hv = tt.heavy_child_table(t.node_child0, t.node_nchild, t.node_freq)
    assert int(hv[0]) == heavy
    x = np.array([[-1], [0], [heavy], [11]], np.int32)
    np.testing.assert_array_equal(
        tt.predict(t, x, ds.attr_is_cont).numpy(),
        np.asarray(jt.predict(jtree, x, ds.attr_is_cont)))


def test_predict_matches_jax_with_unknowns(rng):
    ds = make_tree_dataset(rng, n=500, unknown_frac=0.2, n_classes=3)
    jtree = c45.build(ds, GrowConfig())
    t = _to_torch(jtree)
    np.testing.assert_array_equal(
        tt.predict(t, ds.x, ds.attr_is_cont).numpy(),
        np.asarray(jt.predict(jtree, ds.x, ds.attr_is_cont)))
    for depth in (1, 3):
        np.testing.assert_array_equal(
            tt.predict(t, ds.x, ds.attr_is_cont, max_depth=depth).numpy(),
            np.asarray(jt.predict(jtree, ds.x, ds.attr_is_cont,
                                  max_depth=depth)))


def test_deep_tree_default_depth():
    """Default descent reaches leaves deeper than 64; explicit truncation
    stops early — the same as the JAX predict."""
    f = _chain_fields(100)
    t = tt.tree_from_numpy(f, "cpu")
    jtree = jt.Tree(**{k: jnp.asarray(v) for k, v in f.items()})
    assert t.depth == 100
    x = np.array([[1]], np.int32)
    cont = np.array([True])
    assert int(tt.predict(t, x, cont)[0]) == 1
    assert int(tt.predict(t, x, cont, max_depth=10)[0]) == 0
    for depth in (None, 10):
        assert int(tt.predict(t, x, cont, max_depth=depth)[0]) == int(
            np.asarray(jt.predict(jtree, x, cont, max_depth=depth))[0])
    empty = tt.Tree.empty(4, 2, device="cpu")
    np.testing.assert_array_equal(
        tt.predict(empty, np.zeros((3, 1), np.int32), cont).numpy(),
        np.zeros(3))


def test_trees_equal_across_packages(rng):
    ds = make_tree_dataset(rng, 300)
    jtree = c45.build(ds, GrowConfig(), capacity=512)
    t = _to_torch(jtree)
    assert tt.trees_equal(t, jtree) and jt.trees_equal(jtree, t)
    other = t.to_numpy()
    other.node_split_bin = other.node_split_bin.copy()
    internal = np.flatnonzero(other.node_nchild[:t.size] > 0)
    other.node_split_bin[internal[-1]] += 1
    assert not tt.trees_equal(t, other)
    freq = dataclasses.replace(t.to_numpy())
    freq.node_freq = freq.node_freq + 5e-4        # inside freq_tol = 1e-3
    assert tt.trees_equal(t, freq) and jt.trees_equal(jtree, freq)
    freq.node_freq = freq.node_freq + 5e-2
    assert not tt.trees_equal(t, freq)
