"""The port's sequential C4.5 oracle against the JAX package's.

``repro_torch.core.c45.build(device="cpu")`` must grow the tree that
``repro.core.c45.build`` grows on the same binned data — ``trees_equal``
(structure exact, ``node_freq`` within atol 1e-3 / rtol 1e-4) with an equal
``task_trace`` — over heaviest-child and fractional unknowns, gain and gain
ratio, ``min_objs`` 2 and 5, attribute masks and integral (with zeros) and
fractional case weights; and the port's frontier engine must equal the
port's oracle.  The semantic cases of ``tests/test_c45_oracle.py`` run
through the port.

Both scorers add a bin prefix in one order
(``repro_torch.core.entropy.prefix_sum`` is ``jnp.cumsum``'s on the CPU),
so fractional weights split on the same thresholds.  One divergence is
allowed, and checked where it happens: two candidate splits whose gains
are equal in exact arithmetic.  ``jnp.log2`` is XLA's ``log(x) / log(2)``,
whose last bit differs from torch's ``log2`` on about 1% of values, and
``W log W - sum n log n`` cancels that to a few 1e-7 of a score, so each
package picks the first maximum of its own rounding (2 of 100 random
datasets of this generator).  Where the trees differ, the first node
whose split differs must have one histogram, total weight and active set
in both builds, and the two choices must score within 1e-5 * (1 + |score|)
of each other under both scorers (the tolerance the CUDA split gain is
held to).
"""

import numpy as np
import pytest
import torch

from conftest import make_tree_dataset
from repro.core import c45 as jc45
from repro.core.config import GrowConfig as JaxGrowConfig
from repro_torch.core import binning, c45, entropy, frontier
from repro_torch.core.config import GrowConfig
from repro_torch.core.tree import predict, trees_equal
from repro_torch.data import datasets


def _build(cols, y, kinds, cfg=GrowConfig(), **kw):
    ds = binning.fit(cols, y, attr_is_cont=kinds, **kw)
    return ds, c45.build(ds, cfg, device="cpu")


def _pred(tree, ds):
    return predict(tree, ds.x, ds.attr_is_cont).numpy()


# ------------------------------------------- tests/test_c45_oracle.py cases

def test_pure_root_is_leaf():
    ds, tree = _build([np.array([1.0, 2.0, 3.0, 4.0])],
                      np.zeros(4, int), [True], n_classes=2)
    assert tree.size == 1 and tree.n_leaves == 1
    assert int(tree.node_class[0]) == 0


def test_single_continuous_split():
    x = np.array([1.0, 2.0, 3.0, 10.0, 11.0, 12.0])
    y = np.array([0, 0, 0, 1, 1, 1])
    ds, tree = _build([x], y, [True])
    t = tree.to_numpy()
    assert int(t.node_attr[0]) == 0
    # threshold must be a value of the WHOLE training set below the midpoint
    assert ds.threshold_value(0, int(t.node_split_bin[0])) == 3.0
    assert (_pred(tree, ds) == y).all()


def test_discrete_split_children_per_domain_value():
    x = np.array([0, 0, 1, 1, 2, 2])
    y = np.array([0, 0, 1, 1, 0, 0])
    ds, tree = _build([x], y, [False])
    t = tree.to_numpy()
    assert int(t.node_attr[0]) == 0
    assert int(t.node_nchild[0]) == 3     # one child per domain value
    assert (_pred(tree, ds) == y).all()


def test_discrete_attr_consumed_in_subtree():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, 200)
    b = rng.integers(0, 3, 200)
    y = (a ^ (b == 1)).astype(int)
    ds, tree = _build([a, b], y, [False, False])
    t = tree.to_numpy()

    def walk(i, used):
        attr = int(t.node_attr[i])
        if attr < 0:
            return
        assert attr not in used
        for j in range(int(t.node_nchild[i])):
            walk(int(t.node_child0[i]) + j, used | {attr})
    walk(0, set())


def test_min_objs_stop():
    ds, tree = _build([np.array([1.0, 2.0, 3.0])], np.array([0, 1, 0]),
                      [True], GrowConfig(min_objs=2.0))
    assert tree.size == 1


def test_unknown_fractional_weights():
    x = np.array([1.0, 1.0, 1.0, 5.0, 5.0, 5.0, np.nan, np.nan])
    y = np.array([0, 0, 0, 1, 1, 1, 0, 1])
    ds, tree = _build([x], y, [True], GrowConfig(unknown_fractional=True))
    t = tree.to_numpy()
    assert int(t.node_attr[0]) == 0
    c0, c1 = int(t.node_child0[0]), int(t.node_child0[0]) + 1
    # each child got 3 known cases + 2 unknowns at weight 3/6 each
    assert t.node_freq[c0].sum() == pytest.approx(4.0, abs=1e-5)
    assert t.node_freq[c1].sum() == pytest.approx(4.0, abs=1e-5)


def test_unknown_heaviest_routing():
    x = np.array([1.0, 1.0, 1.0, 1.0, 5.0, 5.0, np.nan])
    y = np.array([0, 0, 0, 0, 1, 1, 1])
    ds, tree = _build([x], y, [True],
                      GrowConfig(unknown_fractional=False, min_objs=1.0))
    t = tree.to_numpy()
    # unknown went to the heavier (left) child with full weight
    assert t.node_freq[int(t.node_child0[0])].sum() == pytest.approx(
        5.0, abs=1e-5)


def test_task_trace_records_dag():
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, 400)
    d = rng.integers(0, 3, 400)
    y = ((x > 0.5) ^ (d == 1)).astype(int)
    ds = binning.fit([x, d], y, attr_is_cont=[True, False])
    trace = []
    tree = c45.build(ds, GrowConfig(), device="cpu", task_trace=trace)
    assert len(trace) == tree.size
    roots = [t for t in trace if t["parent"] < 0]
    assert len(roots) == 1 and roots[0]["r"] == 400
    internal = sum(1 for t in trace if t["n_children"] > 0)
    assert internal == tree.size - tree.n_leaves


def test_gain_ratio_criterion_builds():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, 300)
    y = (x > 0.4).astype(int)
    ds = binning.fit([x], y, attr_is_cont=[True])
    tree = c45.build(ds, GrowConfig(criterion="gain_ratio"), device="cpu")
    assert (_pred(tree, ds) == y).mean() > 0.95


def test_build_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    ds = make_tree_dataset(np.random.default_rng(0), 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        c45.build(ds)
    tree = c45.build(ds, device="cpu")
    assert tree.node_attr.device.type == "cpu"


# ------------------------------------------ the port against the JAX oracle

HOOKS = ("none", "mask", "boot", "frac_w", "mask_boot")


def _case(seed):
    """Case ``seed`` of the differential: its dataset, config and hooks."""
    rng = np.random.default_rng(1000 + seed)
    ds = make_tree_dataset(
        rng, int(rng.integers(100, 260)), n_cont=int(rng.integers(1, 4)),
        n_disc=int(rng.integers(0, 3)), n_classes=int(rng.integers(2, 4)),
        unknown_frac=0.0 if seed % 8 == 7 else 0.15)
    kw = dict(unknown_fractional=bool(seed % 2),
              criterion=("gain", "gain_ratio")[(seed // 2) % 2],
              min_objs=(2.0, 5.0)[(seed // 4) % 2])
    hook = HOOKS[seed % len(HOOKS)]
    hooks = {}
    if "mask" in hook:
        mask = rng.random(ds.n_attrs) < 0.6
        mask[int(rng.integers(ds.n_attrs))] = True
        hooks["attr_mask"] = mask
    if "boot" in hook:      # bootstrap counts, zeros included
        hooks["case_w"] = np.bincount(
            rng.integers(0, ds.n_cases, ds.n_cases),
            minlength=ds.n_cases).astype(np.float32)
    if hook == "frac_w":
        hooks["case_w"] = rng.uniform(0.05, 3.0, ds.n_cases).astype(
            np.float32)
    return ds, kw, hooks


TIE_TOL = 1e-5


def _recorded(monkeypatch, module, to_numpy):
    """Record, for every node of ``module``'s build that is scored, its
    histogram, total weight, (score, split_bin) and active attributes, as
    numpy."""
    calls = []
    split_att, pick = module.split_att, module.entropy.pick_best_attribute

    def split_att_spy(hist, total_w, ds, cfg):
        score, split_bin = split_att(hist, total_w, ds, cfg)
        calls.append(dict(hist=to_numpy(hist), total_w=float(total_w),
                          score=to_numpy(score),
                          split_bin=to_numpy(split_bin)))
        return score, split_bin

    def pick_spy(score, active):
        calls[-1]["active"] = to_numpy(active)[0]
        return pick(score, active)
    monkeypatch.setattr(module, "split_att", split_att_spy)
    monkeypatch.setattr(module.entropy, "pick_best_attribute", pick_spy)
    return calls


def _choice(call):
    """(attribute, bin) of the node's split, None for a leaf."""
    score = np.where(call["active"], call["score"], -np.inf)
    attr = int(np.argmax(score))
    if not score[attr] > entropy.EPS_GAIN:
        return None
    return attr, int(call["split_bin"][attr])


@pytest.mark.parametrize("seed", range(40))
def test_port_c45_equals_jax_c45(seed, monkeypatch):
    ds, kw, hooks = _case(seed)
    want_trace, got_trace = [], []
    want_calls = _recorded(monkeypatch, jc45, np.asarray)
    got_calls = _recorded(monkeypatch, c45, lambda t: t.numpy())
    want = jc45.build(ds, JaxGrowConfig(**kw), task_trace=want_trace, **hooks)
    got = c45.build(ds, GrowConfig(**kw), device="cpu",
                    task_trace=got_trace, **hooks)
    if trees_equal(got, want) and got_trace == want_trace:
        return
    # a tie: the first node whose split differs is the same node in both
    # builds, and both scorers score the two choices alike
    diverged = [(w, g) for w, g in zip(want_calls, got_calls)
                if _choice(w) != _choice(g)]
    assert diverged, "the trees differ with the same split choices"
    w, g = diverged[0]
    np.testing.assert_array_equal(g["hist"], w["hist"])
    np.testing.assert_array_equal(g["active"], w["active"])
    assert g["total_w"] == w["total_w"]
    assert None not in (_choice(w), _choice(g)), "a split against a leaf"
    for scorer in ("jax", "port"):
        gains = [_gain_of(scorer, w, choice, ds, kw)
                 for choice in (_choice(w), _choice(g))]
        assert abs(gains[0] - gains[1]) <= TIE_TOL * (1 + abs(gains[0])), (
            f"not a tie under the {scorer} scorer: {_choice(w)} "
            f"{gains[0]} vs {_choice(g)} {gains[1]}")


def _gain_of(scorer, call, choice, ds, kw):
    """The score of one (attribute, bin) split of the node under one
    package's scorer: a continuous threshold as the one candidate of a
    two-bin histogram (left and right of it), a discrete attribute as
    scored."""
    import jax.numpy as jnp
    from repro.core import entropy as jentropy
    attr, split_bin = choice
    if not ds.attr_is_cont[attr]:
        return float(call["score"][attr]) if scorer == "jax" else float(
            entropy.gains_from_histogram(
                torch.as_tensor(call["hist"]),
                total_w=torch.tensor(np.float32(call["total_w"])),
                attr_is_cont=ds.attr_is_cont, n_bins=ds.n_bins,
                min_objs=kw["min_objs"], criterion=kw["criterion"]
            )[0][attr])
    h = call["hist"][attr].astype(np.float64)
    two = np.stack([h[:split_bin + 1].sum(0),
                    h[split_bin + 1:].sum(0)]).astype(np.float32)
    args = dict(n_bins=2, min_objs=kw["min_objs"],
                criterion=kw["criterion"])
    if scorer == "jax":
        return float(jentropy.gains_for_continuous(
            jnp.asarray(two), total_w=jnp.float32(call["total_w"]),
            **args)[0])
    return float(entropy.gains_for_continuous(
        torch.as_tensor(two), total_w=torch.tensor(
            np.float32(call["total_w"])), **args)[0])


@pytest.mark.parametrize("b", [1, 15, 16, 17, 100, 128, 256, 257, 1000,
                               5000])
def test_prefix_sum_adds_as_jnp_cumsum(b):
    """Bitwise, on random f32 weights: the scorer's thresholds see the
    JAX package's prefix sums."""
    import jax.numpy as jnp
    x = np.random.default_rng(b).uniform(0, 3, (3, b, 4)).astype(np.float32)
    want = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-2))
    np.testing.assert_array_equal(
        entropy.prefix_sum(torch.as_tensor(x), -2).numpy(), want)


def test_differential_covers_its_axes():
    """The 40 cases span every axis the oracle's rounding touches."""
    seen = set()
    for seed in range(40):
        ds, kw, hooks = _case(seed)
        unknown = bool((ds.x < 0).any())
        seen.add(("unknown", unknown, kw["unknown_fractional"]))
        seen.add(("criterion", kw["criterion"]))
        seen.add(("min_objs", kw["min_objs"]))
        seen.add(("mask", "attr_mask" in hooks))
        w = hooks.get("case_w")
        if w is not None:
            seen.add(("weights", "integral" if np.all(w == np.round(w))
                      else "fractional", bool((w == 0).any())))
    for axis in [("unknown", True, False), ("unknown", True, True),
                 ("criterion", "gain"), ("criterion", "gain_ratio"),
                 ("min_objs", 2.0), ("min_objs", 5.0), ("mask", True),
                 ("weights", "integral", True),
                 ("weights", "fractional", False)]:
        assert axis in seen, axis


def test_helpers_match_jax():
    """node_histogram, class_frequencies and split_node's children."""
    ds, _, _ = _case(3)
    rng = np.random.default_rng(5)
    idx = np.sort(rng.choice(ds.n_cases, ds.n_cases // 2, replace=False))
    w = rng.uniform(0.1, 2.0, idx.size).astype(np.float32)
    ti, tw = torch.as_tensor(idx), torch.as_tensor(w)
    np.testing.assert_array_equal(
        c45.node_histogram(ds, ti, tw).numpy(),
        jc45.node_histogram(ds, idx, w))
    np.testing.assert_array_equal(c45.class_frequencies(ds, ti, tw),
                                  jc45.class_frequencies(ds, idx, w))
    active = np.ones(ds.n_attrs, bool)
    freq = jc45.class_frequencies(ds, idx, w)
    for fractional in (False, True):
        cfg = dict(unknown_fractional=fractional)
        want = jc45.split_node(ds, JaxGrowConfig(**cfg), idx=idx, w=w,
                               active=active, depth=0, freq=freq, cls=0)
        got = c45.split_node(ds, GrowConfig(**cfg), idx=ti, w=tw,
                             active=active, depth=0, freq=freq, cls=0)
        assert (got.attr, got.split_bin, got.n_children) == (
            want.attr, want.split_bin, want.n_children)
        for j in range(want.n_children):
            np.testing.assert_array_equal(got.child_idx[j].numpy(),
                                          want.child_idx[j])
            np.testing.assert_array_equal(got.child_w[j].numpy(),
                                          want.child_w[j])
            np.testing.assert_array_equal(got.child_freq[j],
                                          want.child_freq[j])
        assert got.child_cls == want.child_cls


# ---------------------- the port's frontier engine against the port's oracle

def _frontier_vs_c45(ds, cfg_kw, **hooks):
    cfg = GrowConfig(**cfg_kw)
    t_c45 = c45.build(ds, cfg, device="cpu", **hooks)
    t_fr = frontier.build(ds, cfg, device="cpu", **hooks)
    assert trees_equal(t_fr, t_c45), (t_fr.size, t_c45.size)
    return t_c45


# the cases of tests/test_torch_frontier.py
@pytest.mark.parametrize("name,scale", [("census_pums", 0.001),
                                        ("syd10m9a", 0.00002)])
def test_frontier_equals_c45_on_bundled(name, scale):
    ds = datasets.load(name, scale=scale, max_bins=16)
    _frontier_vs_c45(ds, dict(max_nodes=4096, frontier_slots=32))


@pytest.mark.parametrize("seed,n,n_cont,n_disc,n_classes,slots,unknown,crit", [
    (0, 300, 2, 2, 2, 7, 0.0, "gain"),
    (1, 400, 3, 1, 3, 64, 0.15, "gain"),
    (2, 250, 1, 3, 4, 2, 0.15, "gain_ratio"),
    (3, 350, 0, 3, 2, 64, 0.0, "gain_ratio"),
    (4, 200, 3, 0, 3, 7, 0.15, "gain"),
])
def test_frontier_equals_c45_on_random(seed, n, n_cont, n_disc, n_classes,
                                       slots, unknown, crit):
    ds = make_tree_dataset(np.random.default_rng(seed), n, n_cont=n_cont,
                           n_disc=n_disc, n_classes=n_classes,
                           unknown_frac=unknown)
    _frontier_vs_c45(ds, dict(max_nodes=1 << 13, frontier_slots=slots,
                              criterion=crit))


def test_frontier_equals_c45_max_depth(rng):
    ds = make_tree_dataset(rng, 400, n_cont=2, n_disc=2)
    assert _frontier_vs_c45(ds, dict(max_depth=3, max_nodes=4096)).depth <= 3


def test_frontier_equals_c45_attr_mask_and_bootstrap(rng):
    ds = make_tree_dataset(rng, 400, n_cont=3, n_disc=2, unknown_frac=0.1)
    case_w = rng.multinomial(ds.n_cases, np.full(ds.n_cases, 1 / ds.n_cases)
                             ).astype(np.float32)
    mask = np.array([True, False, True, True, False])
    _frontier_vs_c45(ds, dict(max_nodes=4096, frontier_slots=16),
                     attr_mask=mask, case_w=case_w)
