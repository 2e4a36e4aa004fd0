"""The slice as a whole: the torch frontier build against the JAX engines.

``repro_torch.core.frontier.build(impl="torch", device="cpu")`` must grow a
tree that ``trees_equal``s both the sequential oracle ``repro.core.c45`` and
``repro.core.frontier.build(impl="jnp")`` on the same binned data: structure
exact, node frequencies within trees_equal's atol 1e-3 / rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from _frontier_sets import as_tensors, kdd_like, one_thread  # noqa: F401
from conftest import make_tree_dataset
from repro.core import c45
from repro.core import frontier as jf
from repro.core.config import GrowConfig as JaxGrowConfig
from repro.core.tree import predict as jax_predict
from repro.data import datasets as jax_datasets
from repro_torch.core import binning, frontier
from repro_torch.core.config import GrowConfig
from repro_torch.core.tree import predict, trees_equal
from repro_torch.data import datasets


def _port(ds) -> binning.BinnedDataset:
    return binning.from_arrays(ds.x, ds.y, ds.w, ds.attr_is_cont, ds.n_bins,
                               ds.bin_edges, ds.n_classes)


def _check(ds, cfg_kw, *, oracle=True, **build_kw):
    jcfg = JaxGrowConfig(**cfg_kw)
    t_jnp = jf.build(ds, jcfg, impl="jnp", **build_kw)
    t_port = frontier.build(_port(ds), GrowConfig(**cfg_kw), impl="torch",
                            device="cpu", **build_kw)
    assert trees_equal(t_port, t_jnp), (t_port.size, t_jnp.size)
    if oracle:
        t_seq = c45.build(ds, jcfg, capacity=jcfg.max_nodes, **build_kw)
        assert trees_equal(t_port, t_seq), (t_port.size, t_seq.size)
    np.testing.assert_array_equal(
        predict(t_port, ds.x, ds.attr_is_cont).numpy(),
        np.asarray(jax_predict(t_jnp, ds.x, ds.attr_is_cont)))
    return t_port


# Table-1 stand-ins at CPU scale, as tests/test_frontier_pallas_path.py
BUNDLED = [("census_pums", 0.001), ("syd10m9a", 0.00002)]


@pytest.mark.parametrize("name,scale", BUNDLED)
@pytest.mark.parametrize("compact", [True, False])
def test_bundled_datasets_match_oracle(name, scale, compact):
    ds = jax_datasets.load(name, scale=scale, max_bins=16)
    port_ds = datasets.load(name, scale=scale, max_bins=16)
    for f in ("x", "y", "w", "attr_is_cont", "n_bins"):
        np.testing.assert_array_equal(getattr(port_ds, f), getattr(ds, f))
    _check(ds, dict(max_nodes=4096, frontier_slots=32, compact=compact))


@pytest.mark.parametrize("seed,n,n_cont,n_disc,n_classes,slots,unknown,crit", [
    (0, 300, 2, 2, 2, 7, 0.0, "gain"),
    (1, 400, 3, 1, 3, 64, 0.15, "gain"),       # unknowns, 3 classes
    (2, 250, 1, 3, 4, 2, 0.15, "gain_ratio"),
    (3, 350, 0, 3, 2, 64, 0.0, "gain_ratio"),  # discrete only
    (4, 200, 3, 0, 3, 7, 0.15, "gain"),        # continuous only
])
def test_random_datasets_match_oracle(seed, n, n_cont, n_disc, n_classes,
                                      slots, unknown, crit):
    ds = make_tree_dataset(np.random.default_rng(seed), n, n_cont=n_cont,
                           n_disc=n_disc, n_classes=n_classes,
                           unknown_frac=unknown)
    _check(ds, dict(max_nodes=1 << 13, frontier_slots=slots, criterion=crit))


def test_capacity_overflow_matches_jnp(rng):
    ds = make_tree_dataset(rng, 500, n_cont=3, n_disc=2, n_classes=3)
    t = _check(ds, dict(max_nodes=16, frontier_slots=8), oracle=False)
    assert t.size <= 16
    _, rows = frontier.build(_port(ds), GrowConfig(max_nodes=16,
                                                   frontier_slots=8),
                             device="cpu", collect_stats=True)
    assert rows[-1]["overflow"]


def test_max_depth_respected(rng):
    ds = make_tree_dataset(rng, 400, n_cont=2, n_disc=2)
    t = _check(ds, dict(max_depth=3, max_nodes=4096))
    assert t.depth <= 3


def test_attr_mask_and_bootstrap_weights(rng):
    ds = make_tree_dataset(rng, 400, n_cont=3, n_disc=2, unknown_frac=0.1)
    case_w = rng.multinomial(ds.n_cases, np.full(ds.n_cases, 1 / ds.n_cases)
                             ).astype(np.float32)    # bootstrap counts
    mask = np.array([True, False, True, True, False])
    _check(ds, dict(max_nodes=4096, frontier_slots=16), attr_mask=mask,
           case_w=case_w)


def test_collect_stats_rows_match_jax(rng):
    ds = make_tree_dataset(rng, 600, n_cont=2, n_disc=1)
    kw = dict(frontier_slots=16, cost_model="nsq", max_nodes=8192)
    t_j, rows_j = jf.build(ds, JaxGrowConfig(**kw), collect_stats=True)
    t_p, rows_p = frontier.build(_port(ds), GrowConfig(**kw), device="cpu",
                                 collect_stats=True)
    assert trees_equal(t_p, t_j)
    assert len(rows_p) == len(rows_j)
    for rp, rj in zip(rows_p, rows_j):
        assert rp["overflow"] is False
        assert {k: rp[k] for k in rj} == pytest.approx(rj, rel=1e-6)
    assert rows_p[0]["n_processed"] == 1 and rows_p[0]["nap_nodes"] == 1
    assert sum(r["n_processed"] for r in rows_p) == t_p.size


@pytest.mark.parametrize("model", ["alpha", "nlogn"])
def test_cost_models_match_jax(model):
    import jax.numpy as jnp
    import torch
    from repro.core import cost_models as jcm
    from repro_torch.core import cost_models as tcm
    r = np.array([0.0, 1.0, 2.0, 50.0, 999.0, 1001.0, 5e4], np.float32)
    c = np.array([1, 9, 9, 3, 40, 2, 9], np.float32)
    want = np.asarray(jcm.build_att_test(model, n_total_cases=1e4,
                                         r=jnp.asarray(r), c=jnp.asarray(c)))
    got = tcm.build_att_test(model, n_total_cases=1e4, r=torch.as_tensor(r),
                             c=torch.as_tensor(c))
    np.testing.assert_array_equal(got.numpy(), want)


def test_binning_matches_jax(rng):
    """Both packages bin the same raw columns into the same bins."""
    from repro.core import binning as jb
    cols = [rng.normal(size=500), rng.integers(-1, 6, 500),
            np.where(rng.random(500) < .1, np.nan, rng.uniform(size=500)),
            np.full(500, 3.0)]
    kinds = [True, False, True, True]
    y = rng.integers(0, 3, 500)
    for max_bins in (1, 16, 256):
        a = jb.fit(cols, y, attr_is_cont=kinds, max_bins=max_bins)
        b = binning.fit(cols, y, attr_is_cont=kinds, max_bins=max_bins)
        for f in ("x", "y", "w", "attr_is_cont", "n_bins"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for ea, eb in zip(a.bin_edges, b.bin_edges):
            np.testing.assert_array_equal(ea, eb)


def test_split_post_default_is_the_plain_version_and_matches_jax(rng):
    """``split_post``'s impl defaults to "torch", the plain version.  Step
    by step from the root, on the same splitPre / splitAtt planes, its
    state and statistics equal the JAX package's splitPost: the node
    arrays below the dump row, the statuses, the active attributes (a
    discrete split attribute retired), the cases' nodes (unknown values to
    the heaviest child), n_nodes and overflow, up to the capacity."""
    import inspect

    import jax.numpy as jnp
    import torch
    params = inspect.signature(frontier.split_post).parameters
    assert params["impl"].default == "torch"
    ds = make_tree_dataset(rng, 500, n_cont=3, n_disc=2, n_classes=3,
                           unknown_frac=0.1)
    kw = dict(max_nodes=48, frontier_slots=8)
    jprob = jf.FrontierProblem.from_dataset(ds, JaxGrowConfig(**kw))
    prob = frontier.FrontierProblem.from_dataset(_port(ds), GrowConfig(**kw))
    cols = (ds.x, ds.y, ds.w, ds.attr_is_cont, ds.n_bins)
    jdata = [jnp.asarray(a) for a in cols]
    tdata = [torch.as_tensor(np.asarray(a, t)) for a, t in zip(
        cols, (np.int32, np.int32, np.float32, bool, np.int32))]
    jstate = jf.init_state(jprob, jdata[1], jdata[2])
    state = frontier.init_state(prob, tdata[1], tdata[2])
    m, steps, retired = kw["max_nodes"], 0, False
    while bool(jnp.any(jstate.status == jf.GrowState.STATUS_OPEN)):
        jpre = jf.split_pre(jstate, prob=jprob)
        jatt = jf.split_att(jstate, jpre, *jdata, prob=jprob, impl="jnp")
        jstate, jstats = jf.split_post(jstate, jpre, jatt, jdata[0],
                                       jdata[3], jdata[4], prob=jprob)
        pre = frontier.split_pre(state, prob=prob)
        att = frontier.split_att(state, pre, *tdata, prob=prob, impl="torch")
        state, stats = frontier.split_post(state, pre, att, tdata[0],
                                           tdata[3], tdata[4], prob=prob)
        for f in ("node_attr", "node_split_bin", "node_child0",
                  "node_nchild", "node_class", "node_freq", "node_depth"):
            np.testing.assert_array_equal(
                getattr(state.tree, f)[:m].numpy(),
                np.asarray(getattr(jstate.tree, f)), err_msg=f)
        for f in ("status", "active", "case_node", "n_nodes", "overflow"):
            got = getattr(state, f)
            np.testing.assert_array_equal(
                (got[:m] if got.ndim and f != "case_node" else got).numpy(),
                np.asarray(getattr(jstate, f)), err_msg=f)
        for key, v in jstats.items():
            assert stats[key].item() == pytest.approx(float(v), rel=1e-6), key
        retired |= bool((~state.active[:m][state.status[:m] > 0]).any())
        steps += 1
    assert steps > 2 and retired and bool(state.overflow)


# ------------------------------------------ the open nodes: one id range

def _walk_set(name):
    if name == "kdd_like":           # 297 nodes, a 70-way root, 6 supersteps
        return kdd_like(300, 7)
    return datasets.load(name, scale=0.0003, max_bins=64)


@pytest.mark.parametrize("name,cfg_kw,masked", [
    ("syd10m9a", dict(frontier_slots=64), False),
    ("syd10m9a", dict(frontier_slots=8), False),
    ("syd10m9a", dict(max_nodes=200, frontier_slots=16), False),
    ("syd10m9a", dict(frontier_slots=16, max_depth=3), False),
    ("syd10m9a", dict(frontier_slots=16), True),
    ("waveform40", dict(frontier_slots=32), False),
    ("kdd_like", dict(frontier_slots=64), False)],
    ids=["syd", "syd-8-slots", "syd-capacity", "syd-depth-3",
         "syd-attr-mask", "waveform40", "kdd_like"])
@pytest.mark.usefixtures("one_thread")
def test_open_nodes_are_one_id_range_every_superstep(name, cfg_kw, masked):
    """What the ``cuda`` build's ``OpenRange`` rests on, on the plain path:
    before every superstep the open ids are exactly ``[lo, n_nodes)``,
    splitPre takes ``n_open = min(K, n_nodes - lo)`` of them from ``lo``,
    and a case's slot is its node less ``lo`` inside that frontier, -1
    outside; ``lo`` then moves past them.  SyD at 64 and 8 slots, capped
    so that it overflows, cut at depth 3 and with an attribute mask;
    Waveform-40 (C 3, A 40); a KDD-like set with unknown values."""
    ds = _walk_set(name)
    cfg = GrowConfig(**{"max_nodes": 4096, **cfg_kw})
    prob = frontier.FrontierProblem.from_dataset(ds, cfg)
    x, y, w, cont, nb = as_tensors(ds)
    mask = torch.as_tensor(np.arange(ds.n_attrs) % 3 != 1) if masked else None
    state = frontier.init_state(prob, y, w, mask)
    m, k = cfg.max_nodes, cfg.frontier_slots
    lo = steps = 0
    overflow = False
    while True:
        n_nodes = int(state.n_nodes)
        open_ids = torch.nonzero(state.status[:m] == 1).flatten()
        assert torch.equal(open_ids, torch.arange(lo, n_nodes)), steps
        if lo == n_nodes:
            break
        pre = frontier.split_pre(state, prob=prob)
        n_open = min(k, n_nodes - lo)
        assert pre["n_open"] == n_open
        assert torch.equal(pre["ids"][:n_open], torch.arange(lo, lo + n_open))
        rel = state.case_node.long() - lo
        assert torch.equal(pre["slot"], torch.where(
            (rel >= 0) & (rel < n_open), rel, -1).to(torch.int32))
        att = frontier.split_att(state, pre, x, y, w, cont, nb, prob=prob,
                                 impl="torch")
        state, stats = frontier.split_post(state, pre, att, x, cont, nb,
                                           prob=prob)
        overflow |= bool(stats["overflow"])
        lo += n_open
        steps += 1
    assert steps > 2
    assert overflow == (m < 1000)


@pytest.mark.parametrize("open_range,read", [
    (False, True), (True, True), (True, False)],
    ids=["plain", "open-range", "open-range-unread"])
def test_split_pre_with_and_without_the_open_range(open_range, read):
    """A state made without the open range (the ``torch`` build's, one
    made by hand) takes the plain splitPre, which waits for its
    ``nonzero`` (``wait.frontier``).  The ``cuda`` build's root state
    carries its frontier: once the loop's test has read the range its
    splitPre waits for nothing and its planes are the plain ones exactly;
    before that read, splitPre refuses it."""
    import dataclasses

    from repro_torch.obs import Tracer
    from repro_torch.obs.trace import NULL
    ds = _walk_set("syd10m9a")
    cfg = GrowConfig(max_nodes=4096, frontier_slots=16)
    prob = frontier.FrontierProblem.from_dataset(ds, cfg)
    _, y, w, _, _ = as_tensors(ds)
    state = frontier.init_state(prob, y, w, open_range=open_range)
    assert (state.open_range is not None) == open_range
    if read:
        assert frontier._open_left(state, cfg, NULL)
    elif open_range:
        with pytest.raises(RuntimeError, match="has not read"):
            frontier.split_pre(state, prob=prob)
        return
    tr = Tracer()
    pre = frontier.split_pre(state, prob=prob, tracer=tr)
    waits = {s for s in tr.span_summary() if s.startswith("wait.")}
    assert waits == (set() if open_range else {"wait.frontier"})
    plain = frontier.split_pre(dataclasses.replace(state, open_range=None),
                               prob=prob)
    assert pre.keys() == plain.keys()
    for key, want in plain.items():
        if isinstance(want, torch.Tensor):
            assert pre[key].dtype == want.dtype, key
            assert torch.equal(pre[key], want), key
        else:
            assert pre[key] == want, key


def test_loop_test_reads_the_range_and_the_live_count():
    """The ``cuda`` build's loop test is one read of the open range's three
    words (lo, n_nodes, n_live): ``n_open`` goes into the coming splitPre,
    ``n_live`` (the live cases splitPost's routing kernel listed) onto the
    range.  The root's range reads (0, 1, N), with no list yet: every case
    is live."""
    from repro_torch.obs.trace import NULL
    ds = _walk_set("syd10m9a")
    cfg = GrowConfig(max_nodes=4096, frontier_slots=16)
    prob = frontier.FrontierProblem.from_dataset(ds, cfg)
    _, y, w, _, _ = as_tensors(ds)
    state = frontier.init_state(prob, y, w, open_range=True)
    rng = state.open_range
    assert rng.bounds.tolist() == [0, 1, ds.n_cases]
    assert int(state.n_nodes) == 1 and not rng.listed and rng.n_live is None
    assert rng.live.dtype == torch.int32
    assert rng.live.shape == (ds.n_cases,)
    assert frontier._open_left(state, cfg, NULL)
    assert (rng.pre["n_open"], rng.n_live) == (1, ds.n_cases)
    # ranges as splitPost's kernels leave them
    for lo, n_nodes, n_live, n_open in ((100, 140, 7, 16), (100, 105, 3, 5),
                                        (140, 140, 0, 0)):
        state.open_range = frontier.OpenRange(
            bounds=torch.tensor([lo, n_nodes, n_live], dtype=torch.int32),
            pre=dict(rng.pre, n_open=None), live=rng.live, listed=True)
        assert frontier._open_left(state, cfg, NULL) == (n_nodes > lo)
        assert state.open_range.pre["n_open"] == n_open
        assert state.open_range.n_live == n_live


@pytest.mark.parametrize("where", ["root", "listed", "uncompacted"])
def test_cuda_histogram_reads_the_open_range_list(where, monkeypatch):
    """On the ``cuda`` path, a state with the open range and ``compact`` set
    hands splitAtt's histogram the routing kernel's list of the live cases
    and the count the loop's test read: no compaction (no ``nonzero``, no
    ``wait.compact``, no gathered copy), a ``compact`` span around the
    handoff.  At the root (no list yet, every case live) and uncompacted it
    passes the rows themselves and no list.  The kernel is stood in for by
    the plain version over the rows the list names, in the list's order
    (shuffled: the routing kernel lists in no fixed order)."""
    from repro_torch.kernels import compaction, histogram, ref
    from repro_torch.obs import Tracer
    from repro_torch.obs.trace import NULL
    ds = _walk_set("syd10m9a")
    cfg = GrowConfig(max_nodes=4096, frontier_slots=16,
                     compact=where != "uncompacted")
    prob = frontier.FrontierProblem.from_dataset(ds, cfg)
    x, y, w, _, _ = as_tensors(ds)
    state = frontier.init_state(prob, y, w, open_range=True)
    rng = state.open_range
    slot = rng.pre["slot"]
    n_live = ds.n_cases
    if where != "root":
        g = torch.Generator().manual_seed(5)
        slot.copy_(torch.randint(-2, 16, slot.shape, generator=g,
                                 dtype=torch.int32))
        live = torch.nonzero(slot >= 0).flatten().to(torch.int32)
        n_live = live.numel()
        rng.live[:n_live] = live[torch.randperm(n_live, generator=g)]
        rng.bounds[1:] = torch.tensor([20, n_live], dtype=torch.int32)
        rng.listed = True
    assert frontier._open_left(state, cfg, NULL)
    kw = dict(n_slots=16, n_bins=prob.n_bins_max, n_classes=prob.n_classes)
    calls = []

    def kernel(x, y, w, slot, *, case_list=None, n_listed=None, **plan):
        calls.append((x, case_list, n_listed))
        if case_list is not None:
            rows = case_list[:n_listed].long()
            x, y, w, slot = (t[rows] for t in (x, y, w, slot))
        return ref.frontier_histogram_ref(x, y, w, slot, **kw)

    def gathered(*args, **kwargs):
        raise AssertionError("the open range's cases were gathered")
    monkeypatch.setattr(histogram, "frontier_histogram", kernel)
    monkeypatch.setattr(compaction, "live_cases", gathered)
    tr = Tracer()
    pre = frontier.split_pre(state, prob=prob)
    hist = frontier._histogram(x, y, w, pre["slot"], n_open=pre["n_open"],
                               prob=prob, impl="cuda", tracer=tr, rng=rng)
    assert torch.equal(hist, ref.frontier_histogram_ref(x, y, w, slot, **kw))
    spans = tr.span_summary()
    assert "wait.compact" not in spans
    assert ("compact" in spans) == cfg.compact
    (got_x, got_list, got_n), = calls
    assert got_x is x
    if where == "listed":
        assert got_list is rng.live and got_n == n_live < ds.n_cases
    else:
        assert got_list is None and got_n is None
