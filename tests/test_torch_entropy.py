"""The torch scorer (repro_torch.core.entropy) against the JAX scorer.

Same numpy inputs through both.  Split bins and the -inf pattern must match
exactly.  Scores: |torch - jax| <= tol * (1 + |jax|) with tol = 1e-5 for the
gain (measured: 4.2e-6 over 1,200 random histograms with up to 23 classes;
XLA's and torch's CPU log2 and sum orders differ in the last bits) and
tol = 1e-4 for the gain ratio (measured: 2.9e-5; dividing by a small split
info amplifies the same rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import entropy as je
from repro_torch.core import entropy as te

GAIN_TOL = 1e-5
RATIO_TOL = 1e-4


def _close(got, want, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin])
                  <= tol * (1 + np.abs(want[fin])))


def _both(fn_name, *args, **kw):
    j = getattr(je, fn_name)(*[jnp.asarray(a) for a in args],
                             **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                    else v) for k, v in kw.items()})
    t = getattr(te, fn_name)(*[torch.as_tensor(a) for a in args],
                             **{k: (torch.as_tensor(v)
                                    if isinstance(v, np.ndarray) else v)
                                for k, v in kw.items()})
    return j, t


# the hand-made cases of tests/test_entropy.py
def _hist(shape, sets):
    h = np.zeros(shape, np.float32)
    for idx, v in sets:
        h[idx] = v
    return h


INFO_CASES = [np.array(c, np.float32) for c in
              ([5, 5], [8, 0], [2, 2, 2, 2], [0, 0], [3, 1, 0, 7.5])]


@pytest.mark.parametrize("counts", INFO_CASES)
def test_info_and_weighted_info(counts):
    for fn in ("info", "weighted_info", "_xlogx"):
        j, t = _both(fn, counts)
        _close(t.numpy(), j, GAIN_TOL)


@pytest.mark.parametrize("children,total_w", [
    (np.array([[6, 0], [0, 6]], np.float32), None),          # perfect
    (np.array([[3, 3], [3, 3]], np.float32), None),          # useless
    (np.array([[6, 0], [0, 6]], np.float32), np.float32(12)),
    (np.array([[6, 0], [0, 6]], np.float32), np.float32(24)),  # F = 1/2
    (np.array([[4, 1, 0], [0, 2, 5], [1, 1, 1]], np.float32), np.float32(20)),
])
def test_split_gain_from_children_and_split_info(children, total_w):
    kw = {} if total_w is None else {"total_w": np.asarray(total_w)}
    j, t = _both("split_gain_from_children", children, **kw)
    _close(t.numpy(), j, GAIN_TOL)
    j, t = _both("split_info", children)
    _close(t.numpy(), j, GAIN_TOL)


@pytest.mark.parametrize("hist,total_w,n_bins,min_objs", [
    # classes split exactly at bin 1|2
    (_hist((4, 2), [((0, 0), 3), ((1, 0), 3), ((2, 1), 3), ((3, 1), 3)]),
     12.0, 4, 2.0),
    # the informative cut leaves 1 < min_objs on the left
    (_hist((3, 2), [((0, 0), 1), ((1, 1), 50), ((2, 1), 50)]), 101.0, 3, 2.0),
])
@pytest.mark.parametrize("criterion", ["gain", "gain_ratio"])
def test_continuous_cases(hist, total_w, n_bins, min_objs, criterion):
    kw = dict(total_w=np.float32(total_w), n_bins=np.int32(n_bins),
              min_objs=min_objs, criterion=criterion)
    (sj, bj), (st, bt) = _both("gains_for_continuous", hist, **kw)
    assert int(bj) == int(bt)
    _close(st.numpy(), sj, RATIO_TOL if criterion == "gain_ratio"
           else GAIN_TOL)


def test_discrete_needs_two_branches():
    hist = _hist((3, 2), [((0, 0), 10.0)])
    j, t = _both("gains_for_discrete", hist, total_w=np.float32(10.0),
                 n_bins=np.int32(3))
    assert float(t) == float(j) == -np.inf


def test_pick_best_attribute_first_max_and_active_mask():
    score = np.array([[0.5, 0.9, 0.9, 0.2], [0.1, 0.0, -np.inf, 0.1]],
                     np.float32)
    for active in (np.ones((2, 4), bool),
                   np.array([[1, 0, 0, 1], [0, 0, 0, 0]], bool)):
        j, t = _both("pick_best_attribute", score, active)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# (K, A, B, C): two classes (SyD, census), three, and KDD's 23
RANDOM_SHAPES = [(6, 5, 33, 2), (4, 3, 13, 3), (3, 4, 7, 23)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("criterion", ["gain", "gain_ratio"])
def test_gains_from_histogram_random(seed, criterion):
    """Random histograms: continuous and discrete attributes, up to 23
    classes, non-empty padding bins, total_w above the known weight."""
    rng = np.random.default_rng(seed)
    k, a, b, c = RANDOM_SHAPES[seed % 3]
    hist = (rng.uniform(0, 10, (k, a, b, c))
            * (rng.random((k, a, b, c)) < .7)).astype(np.float32)
    if seed % 2:
        hist = np.floor(hist)                  # integral counts
    tw = (hist.sum((1, 2, 3)) / a + rng.uniform(0, 3, k)).astype(np.float32)
    cont = rng.random(a) < .5
    nb = rng.integers(1, b + 1, a).astype(np.int32)
    tol = RATIO_TOL if criterion == "gain_ratio" else GAIN_TOL
    for min_objs in (2.0, 0.0):
        (sj, bj), (st, bt) = _both(
            "gains_from_histogram", hist, total_w=tw, attr_is_cont=cont,
            n_bins=nb, min_objs=min_objs, criterion=criterion)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        _close(st.numpy(), sj, tol)
        # and each branch on its own
        (sj, bj), (st, bt) = _both(
            "gains_for_continuous", hist, total_w=tw[:, None], n_bins=nb,
            min_objs=min_objs, criterion=criterion)
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        _close(st.numpy(), sj, tol)
        j, t = _both("gains_for_discrete", hist, total_w=tw[:, None],
                     n_bins=nb, min_objs=min_objs, criterion=criterion)
        _close(t.numpy(), j, tol)


@pytest.mark.parametrize("seed", range(4))
def test_fayyad_irani_mask(seed):
    rng = np.random.default_rng(seed)
    b, c = rng.integers(3, 13), rng.integers(2, 5)
    hist = rng.integers(0, 7, (5, b, c)).astype(np.float32)
    hist[:, rng.integers(0, b, 3)] = 0
    j, t = _both("fayyad_irani_mask", hist)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_constants_match():
    assert te.EPS_W == je.EPS_W and te.EPS_GAIN == je.EPS_GAIN
