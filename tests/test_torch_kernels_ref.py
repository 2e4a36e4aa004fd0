"""Plain versions of the CUDA kernels (repro_torch.kernels.ref) and the CPU
dispatch of repro_torch.kernels.ops, against the JAX references.

Histogram: integral weights must match exactly (f32 sums of integers below
2^24 are exact in any order); random f32 weights within atol 1e-5, rtol 1e-6
(measured: 0 on these shapes, where both sides happen to add in case order;
neither promises an order).  Split gain: bins exact, scores within
1e-5 * (1 + |score|) for the gain and 1e-4 for the gain ratio, as in
test_torch_entropy.py.
"""

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels import ref as jref
from repro_torch.kernels import compaction, ops, ref

# one compiled program per shape instead of one per primitive
_jax_split_gain = jax.jit(jref.split_gain_ref,
                          static_argnames=("min_objs", "criterion"))

HIST_SHAPES = [
    # (N, A, B, C, K): the shapes of tests/test_kernels.py
    (64, 1, 4, 2, 3),
    (200, 3, 13, 4, 10),
    (500, 5, 32, 2, 16),
    (130, 2, 7, 23, 5),
    (96, 4, 128, 3, 8),
    (300, 3, 11, 4, 9),        # the conservation case
]


def _hist_problem(rng, n, a, b, c, k, *, integral):
    x = rng.integers(-1, b, (n, a)).astype(np.int32)
    y = rng.integers(0, c, n).astype(np.int32)
    w = (rng.integers(0, 4, n) if integral
         else rng.uniform(0.1, 2.0, n)).astype(np.float32)
    slot = rng.integers(-1, k, n).astype(np.int32)
    return x, y, w, slot


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("n,a,b,c,k", HIST_SHAPES)
@pytest.mark.parametrize("integral", [True, False])
def test_histogram_ref_matches_jax(n, a, b, c, k, integral):
    rng = np.random.default_rng(n + a)
    x, y, w, slot = _hist_problem(rng, n, a, b, c, k, integral=integral)
    kw = dict(n_slots=k, n_bins=b, n_classes=c)
    want = np.asarray(jref.frontier_histogram_ref(x, y, w, slot, **kw))
    got = ref.frontier_histogram_ref(*_t(x, y, w, slot), **kw)
    assert got.shape == (k, a, b + 1, c) and got.dtype == torch.float32
    if integral:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
    # the CPU dispatch runs the plain version
    np.testing.assert_array_equal(
        ops.frontier_histogram(*_t(x, y, w, slot), **kw).numpy(),
        got.numpy())
    # conservation: all in-frontier weight lands once per attribute
    assert got.sum().item() == pytest.approx(float(w[slot >= 0].sum()) * a,
                                             rel=1e-5)


@pytest.mark.parametrize("frac_active", [0.0, 0.03, 0.5, 1.0])
def test_compaction_matches_full_histogram(frac_active):
    rng = np.random.default_rng(int(frac_active * 100))
    n, a, b, c, k = 700, 3, 9, 4, 6
    x, y, w, slot = _hist_problem(rng, n, a, b, c, k, integral=True)
    slot[rng.random(n) >= frac_active] = -1
    kw = dict(n_slots=k, n_bins=b, n_classes=c)
    full = ref.frontier_histogram_ref(*_t(x, y, w, slot), **kw)
    live = compaction.live_cases(*_t(x, y, w, slot))
    assert live[0].shape[0] == int((slot >= 0).sum())
    got = ops.frontier_histogram(*live, **kw)
    np.testing.assert_array_equal(got.numpy(), full.numpy())


def _gain_check(hist, tw, cont, nb, criterion, min_objs=2.0):
    want_s, want_b = _jax_split_gain(hist, tw, cont, nb, min_objs=min_objs,
                                     criterion=criterion)
    got_s, got_b = ref.split_gain_ref(*_t(hist, tw, cont, nb),
                                      min_objs=min_objs, criterion=criterion)
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    want_s = np.asarray(want_s, np.float64)
    got = got_s.numpy().astype(np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want_s))
    fin = np.isfinite(want_s)
    tol = 1e-4 if criterion == "gain_ratio" else 1e-5
    assert np.all(np.abs(got[fin] - want_s[fin])
                  <= tol * (1 + np.abs(want_s[fin])))
    d_s, d_b = ops.split_gain(*_t(hist, tw, cont, nb), min_objs=min_objs,
                              criterion=criterion)
    assert torch.equal(d_b, got_b) and torch.equal(d_s, got_s)


@pytest.mark.parametrize("criterion", ["gain", "gain_ratio"])
@pytest.mark.parametrize("k,a,b,c", [(4, 3, 8, 2), (10, 5, 13, 4),
                                     (3, 2, 64, 3)])
def test_split_gain_ref_matches_jax(k, a, b, c, criterion):
    rng = np.random.default_rng(k * a)
    hist = rng.uniform(0, 10, (k, a, b, c)).astype(np.float32)
    tw = (hist.sum((1, 2, 3)) / a + rng.uniform(0, 2, k)).astype(np.float32)
    cont = rng.random(a) < 0.6
    nb = rng.integers(2, b + 1, a).astype(np.int32)
    _gain_check(hist, tw, cont, nb, criterion)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000), k=st.integers(1, 12),
       a=st.integers(1, 6), b=st.integers(2, 20), c=st.integers(2, 6))
def test_split_gain_ref_property_sweep(seed, k, a, b, c):
    rng = np.random.default_rng(seed)
    hist = (rng.uniform(0, 5, (k, a, b, c))
            * (rng.random((k, a, b, c)) < 0.7)).astype(np.float32)
    tw = hist.sum((1, 2, 3)).astype(np.float32) / max(a, 1)
    cont = rng.random(a) < 0.5
    nb = rng.integers(2, b + 1, a).astype(np.int32)
    _gain_check(hist, tw, cont, nb, "gain")


def test_split_gain_ref_takes_the_strided_histogram_view():
    """The build scores the first B bins of the (K, A, B+1, C) histogram in
    place; the view and a contiguous copy score the same."""
    rng = np.random.default_rng(5)
    k, a, b, c = 5, 4, 9, 2
    hist_u = torch.as_tensor(rng.integers(0, 6, (k, a, b + 1, c)
                                          ).astype(np.float32))
    view = hist_u[:, :, :b, :]
    tw = hist_u[:, 0].sum((1, 2))
    cont = torch.tensor([True, False, True, False])
    nb = torch.tensor([9, 3, 5, 9], dtype=torch.int32)
    s1, b1 = ref.split_gain_ref(view, tw, cont, nb)
    s2, b2 = ref.split_gain_ref(view.contiguous(), tw, cont, nb)
    assert torch.equal(s1, s2) and torch.equal(b1, b2)


# (T, M, A, N, block_n): a lone root leaf, N off the block, wide tables
INFER_SHAPES = [(1, 1, 3, 5, 8), (3, 40, 4, 37, 8), (5, 64, 6, 100, 16),
                (2, 200, 2, 257, 32), (4, 9, 1, 1, 8)]


@pytest.mark.parametrize("t,m,a,n,block_n", INFER_SHAPES)
@pytest.mark.parametrize("depth_cut", [0, 2, None])
def test_forest_predict_ref_matches_jax_pallas(t, m, a, n, block_n,
                                               depth_cut):
    """Labels exact against the Pallas kernel in interpret mode: leaves and
    padding rows (attr -1), unknowns, discrete bins >= nchild, truncated
    descents."""
    from _forest_tables import random_cases, random_forest_table
    from repro.kernels import tree_infer as jtree_infer
    rng = np.random.default_rng(t * m + a)
    cont = rng.random(a) < 0.5
    tab, levels = random_forest_table(rng, t, m, cont)
    x = random_cases(rng, n, cont)
    depth = levels if depth_cut is None else min(levels, depth_cut)
    want = np.asarray(jtree_infer.forest_predict(
        tab, x, cont, max_depth=depth, block_n=block_n, interpret=True))
    got = ref.forest_predict_ref(*_t(tab, x, cont), max_depth=depth)
    assert got.dtype == torch.int32 and got.shape == (t, n)
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU dispatch runs the plain version
    assert torch.equal(ops.forest_predict(*_t(tab, x, cont),
                                          max_depth=depth), got)


def test_forest_predict_ref_leaves_absorb():
    """Steps past the deepest leaf change nothing."""
    from _forest_tables import random_cases, random_forest_table
    rng = np.random.default_rng(11)
    cont = np.array([True, False, True])
    tab, levels = random_forest_table(rng, 3, 80, cont)
    x = _t(random_cases(rng, 64, cont))[0]
    args = (torch.as_tensor(tab), x, torch.as_tensor(cont))
    assert torch.equal(ref.forest_predict_ref(*args, max_depth=levels),
                       ref.forest_predict_ref(*args, max_depth=levels + 7))


@pytest.mark.parametrize("n,threads", [(1, 32), (33, 64), (257, 256),
                                       (10_000_000, 1024)])
def test_plan_infer_blocks(n, threads):
    """256 trees: the widest block up to 1,024 cases, no wider than the
    cases in whole warps, whose grid keeps a block on every SM."""
    from repro_torch.kernels import autotune
    plan = autotune.plan_infer_blocks(n_cases=n, n_trees=256)
    assert plan.threads == threads and plan.tree_blocks == 256
    assert plan.blocks == 256 * -(-n // threads) >= autotune.H100_SMS


def test_plan_infer_blocks_pins_and_refuses():
    from repro_torch.kernels import autotune
    shape = dict(n_cases=10, n_trees=1)
    assert autotune.plan_infer_blocks(**shape, block_n=64).threads == 64
    with pytest.raises(ValueError, match="multiple of 32"):
        autotune.plan_infer_blocks(**shape, block_n=48)
    with pytest.raises(ValueError, match="multiple of 32"):
        autotune.plan_infer_blocks(**shape, block_n=2048)


def test_tree_infer_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel: the wrapper raises, and only
    ops's device dispatch sends it to the plain version."""
    from repro_torch.kernels import tree_infer
    tab = torch.zeros((1, 1, tree_infer.NODE_COLS), dtype=torch.int32)
    x = torch.zeros((3, 2), dtype=torch.int32)
    cont = torch.zeros(2, dtype=torch.bool)
    before = tree_infer.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tree_infer.forest_predict(tab, x, cont, max_depth=1)
    assert tree_infer.LAUNCHES == before
    assert torch.equal(ops.forest_predict(tab, x, cont, max_depth=1),
                       torch.zeros((1, 3), dtype=torch.int32))
