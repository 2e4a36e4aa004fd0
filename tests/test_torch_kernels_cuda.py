"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels have no CPU mode); without
one each test skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Histogram: exact for integral weights, atol 1e-4 / rtol 1e-5 for random f32
weights (device atomics add in no fixed order), in every regime of its plan
and with each plan pinned.  Split gain: bins and the
-inf pattern exact, scores within 1e-5 * (1 + |score|) (the discrete branch
sums its bins in another order than torch.sum).  Forest traversal: labels
exact.  splitPost's two kernels: every node array, status, active row,
case node and statistic exact against the plain ``split_post``.  Flash
attention (bf16: the tensor-core kernel, f32: the scalar one):
f32 atol 3e-5, bf16 atol 2e-2 (another summation order, P rounded to bf16
before P . V; one bf16 rounding step of outputs near 1).  Its log-sum-exp
atol 1e-4, the output unchanged bit for bit when it is written.  The
backward (bf16: the tensor-core kernels, f32: the scalar ones): f32 atol
2e-4, bf16 within 1% of the largest plain gradient, and repeatable bit for
bit.  The same tolerances hold the kernels at the attention layers of
every ported architecture (GQA groups 1-7 and 10, MHA).  Under DTensor on
a one-rank NCCL mesh each kernel's op (its sharding strategy, replicated or
sharded) launches the kernel once and equals the plain launch bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,a,b,c,k", [
    (64, 1, 4, 2, 3), (200, 3, 13, 4, 10), (130, 2, 7, 23, 5),
    (96, 4, 128, 3, 8), (20_000, 9, 256, 2, 256), (5_000, 40, 128, 2, 256)])
@pytest.mark.parametrize("integral", [True, False])
def test_histogram_kernel_matches_plain(dev, n, a, b, c, k, integral):
    from repro_torch.kernels import histogram, ref
    rng = np.random.default_rng(n + a)
    x = torch.as_tensor(rng.integers(-1, b, (n, a)).astype(np.int32),
                        device=dev)
    y = torch.as_tensor(rng.integers(0, c, n).astype(np.int32), device=dev)
    w = torch.as_tensor((rng.integers(0, 4, n) if integral else
                         rng.uniform(0.1, 2.0, n)).astype(np.float32),
                        device=dev)
    slot = torch.as_tensor(rng.integers(-1, k, n).astype(np.int32),
                           device=dev)
    kw = dict(n_slots=k, n_bins=b, n_classes=c)
    before = histogram.LAUNCHES
    got = histogram.frontier_histogram(x, y, w, slot, **kw)
    want = ref.frontier_histogram_ref(x, y, w, slot, **kw)
    torch.cuda.synchronize()
    assert histogram.LAUNCHES == before + 1
    if integral:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


# The regimes of the histogram's plan (autotune.plan_histogram), as
# (name, N, A, B, C, K, live slots): every case in one slot with 5-, 9- and
# 20-value discrete columns (shared window), 20% of the cases live over 256
# slots and compacted (direct adds), census_pums' shape, K = 1, N = 1.
HIST_REGIMES = [
    ("one slot, low-cardinality columns", 400_000, 9, 256, 2, 256, 1),
    ("20% live over 256 slots, compacted", 500_000, 9, 256, 2, 256, 256),
    ("census shape, one slot", 100_000, 40, 128, 2, 256, 1),
    ("census shape, 256 slots", 100_000, 40, 128, 2, 256, 256),
    ("K = 1", 200_000, 9, 256, 2, 1, 1),
    ("N = 1", 1, 9, 256, 2, 256, 1),
]


@pytest.mark.parametrize("regime", HIST_REGIMES, ids=lambda r: r[0])
@pytest.mark.parametrize("pins", [{}, dict(block_k=0),
                                  dict(block_k=1, block_t=96)],
                         ids=["planned", "direct", "shared-1-slot-windows"])
@pytest.mark.parametrize("integral", [True, False])
def test_histogram_kernel_regimes(dev, regime, pins, integral):
    from repro_torch.kernels import compaction, histogram, ref
    _, n, a, b, c, k, live = regime
    rng = np.random.default_rng(n + a + k)
    x = rng.integers(-1, b, (n, a)).astype(np.int32)
    for col, card in zip(range(a - 3, a), (5, 9, 20)):
        x[:, col] = rng.integers(0, card, n)
    y = rng.integers(0, c, n).astype(np.int32)
    w = (rng.integers(0, 4, n) if integral
         else rng.uniform(0.1, 2.0, n)).astype(np.float32)
    slot = rng.integers(0, live, n).astype(np.int32)
    if live > 1:
        slot[rng.random(n) >= 0.2] = -1
    args = [torch.as_tensor(v, device=dev) for v in (x, y, w, slot)]
    kw = dict(n_slots=k, n_bins=b, n_classes=c)
    want = ref.frontier_histogram_ref(*args, **kw)
    if live > 1:
        args = list(compaction.live_cases(*args))
    got = histogram.frontier_histogram(*args, n_live_slots=live, **kw,
                                       **pins)
    torch.cuda.synchronize()
    if integral:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


def test_histogram_kernel_counts_slots_beyond_the_hint(dev):
    """A live-slot hint below the real slots drops nothing."""
    from repro_torch.kernels import histogram, ref
    rng = np.random.default_rng(11)
    n, a, b, c, k = 50_000, 5, 32, 3, 16
    args = [torch.as_tensor(v, device=dev) for v in (
        rng.integers(-1, b, (n, a)).astype(np.int32),
        rng.integers(0, c, n).astype(np.int32),
        rng.integers(0, 3, n).astype(np.float32),
        rng.integers(-1, k, n).astype(np.int32))]
    kw = dict(n_slots=k, n_bins=b, n_classes=c)
    want = ref.frontier_histogram_ref(*args, **kw)
    for hint, pins in ((1, {}), (4, dict(block_k=2)), (3, dict(block_k=0))):
        got = histogram.frontier_histogram(*args, n_live_slots=hint, **kw,
                                           **pins)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (hint, pins)


# (name, N, A, B, C, K, live slots) of the list's regimes: the deep
# supersteps' direct adds, one slot dense enough for a shared window,
# census_pums' width
LIST_REGIMES = [
    ("20% live over 256 slots", 500_000, 9, 256, 2, 256, 256),
    ("20% live in one slot", 400_000, 9, 256, 2, 256, 1),
    ("census shape, 20% live over 256 slots", 100_000, 40, 128, 2, 256, 256),
]


@pytest.mark.parametrize("regime", LIST_REGIMES, ids=lambda r: r[0])
@pytest.mark.parametrize("pins", [{}, dict(block_k=0),
                                  dict(block_k=1, block_t=96)],
                         ids=["planned", "direct", "shared-1-slot-windows"])
def test_histogram_through_a_list_equals_the_gathered_rows(dev, regime,
                                                           pins):
    """The kernel reading the live cases through a list of their indices
    (shuffled: the routing kernel lists in no fixed order; the buffer's
    entries past the count are junk) equals, bit for bit, the kernel on
    ``compaction.live_cases``' gathered copy of them (integral weights) and
    the plain version, under the same plan; it counts a launch under
    ``SOURCES["list"]``."""
    from repro_torch.kernels import autotune, compaction, histogram, ref
    _, n, a, b, c, k, live = regime
    rng = np.random.default_rng(n + a + live)
    x = rng.integers(-1, b, (n, a)).astype(np.int32)
    for col, card in zip(range(a - 3, a), (5, 9, 20)):
        x[:, col] = rng.integers(0, card, n)
    slot = rng.integers(0, live, n).astype(np.int32)
    slot[rng.random(n) >= 0.2] = -1
    args = [torch.as_tensor(v, device=dev) for v in (
        x, rng.integers(0, c, n).astype(np.int32),
        rng.integers(0, 4, n).astype(np.float32), slot)]
    listed = np.flatnonzero(slot >= 0)
    buf = rng.integers(0, n, n).astype(np.int32)       # junk past the count
    buf[:listed.size] = rng.permutation(listed)
    buf = torch.as_tensor(buf, device=dev)
    kw = dict(n_slots=k, n_bins=b, n_classes=c, n_live_slots=live, **pins)
    gathered = histogram.frontier_histogram(
        *compaction.live_cases(*args), **kw)
    sources = dict(histogram.SOURCES)
    plans = dict(histogram.PLANS)
    got = histogram.frontier_histogram(*args, case_list=buf,
                                       n_listed=listed.size, **kw)
    torch.cuda.synchronize()
    mode = autotune.plan_histogram(n_cases=listed.size, n_attrs=a,
                                   **kw).mode
    assert histogram.SOURCES == {**sources, "list": sources["list"] + 1}
    assert histogram.PLANS == {**plans, mode: plans[mode] + 1}
    assert torch.equal(got, gathered)
    assert torch.equal(got, ref.frontier_histogram_ref(*args, n_slots=k,
                                                       n_bins=b, n_classes=c))


@pytest.mark.parametrize("criterion", ["gain", "gain_ratio"])
@pytest.mark.parametrize("k,a,b,c", [(4, 3, 8, 2), (10, 5, 13, 4),
                                     (16, 6, 13, 23), (7, 5, 300, 3),
                                     (256, 9, 256, 2), (3, 4, 1, 2),
                                     (256, 40, 128, 2), (1, 9, 256, 2),
                                     (5, 4, 100, 2), (3, 6, 33, 2),
                                     (2, 3, 257, 2)])
def test_split_gain_kernel_matches_plain(dev, k, a, b, c, criterion):
    from repro_torch.kernels import ref, split_gain
    rng = np.random.default_rng(k * a)
    hist = torch.as_tensor(rng.integers(0, 6, (k, a, b, c)).astype(
        np.float32) * (rng.random((k, a, b, c)) < 0.7), device=dev)
    tw = hist.sum((1, 2, 3)) / a + torch.as_tensor(
        rng.integers(0, 4, k).astype(np.float32), device=dev)
    cont = torch.as_tensor(rng.random(a) < 0.5, device=dev)
    nb = torch.as_tensor(rng.integers(1, b + 1, a).astype(np.int32),
                         device=dev)
    for min_objs in (2.0, 0.0):
        s_k, b_k = split_gain.split_gain(hist, tw, cont, nb,
                                         min_objs=min_objs,
                                         criterion=criterion)
        s_r, b_r = ref.split_gain_ref(hist, tw, cont, nb, min_objs=min_objs,
                                      criterion=criterion)
        assert torch.equal(b_k, b_r)
        fin = torch.isfinite(s_r)
        assert torch.equal(fin, torch.isfinite(s_k))
        assert torch.all((s_k[fin] - s_r[fin]).abs()
                         <= 1e-5 * (1 + s_r[fin].abs()))


@pytest.mark.parametrize("criterion", ["gain", "gain_ratio"])
@pytest.mark.parametrize("k,a,b,c", [(256, 9, 256, 2), (37, 6, 300, 23)])
def test_split_gain_kernel_sparse_and_padded_rows(dev, k, a, b, c,
                                                  criterion):
    """Mostly empty bins (the kernel skips an empty bin and scores an
    invalid threshold from its weights alone) and padded slots (all zero,
    total weight 0: -inf, or 0 when min_objs is 0): bins, the -inf pattern
    and the scores of the padded rows exactly as the plain version."""
    from repro_torch.kernels import ref, split_gain
    rng = np.random.default_rng(k + b)
    hist = rng.integers(0, 4, (k, a, b, c)).astype(np.float32) * (
        rng.random((k, a, b, c)) < 0.05)
    hist[k // 2:] = 0
    hist = torch.as_tensor(hist, device=dev)
    tw = hist.sum((1, 2, 3)) / a
    cont = torch.as_tensor(np.arange(a) % 3 != 2, device=dev)
    nb = torch.as_tensor(rng.integers(1, b + 1, a).astype(np.int32),
                         device=dev)
    for min_objs in (2.0, 0.0):
        s_k, b_k = split_gain.split_gain(hist, tw, cont, nb,
                                         min_objs=min_objs,
                                         criterion=criterion)
        s_r, b_r = ref.split_gain_ref(hist, tw, cont, nb, min_objs=min_objs,
                                      criterion=criterion)
        assert torch.equal(b_k, b_r)
        assert torch.equal(s_k[k // 2:], s_r[k // 2:])
        fin = torch.isfinite(s_r)
        assert torch.equal(fin, torch.isfinite(s_k))
        assert torch.all((s_k[fin] - s_r[fin]).abs()
                         <= 1e-5 * (1 + s_r[fin].abs()))


@pytest.mark.parametrize("b,c", [(256, 2), (13, 23)])
@pytest.mark.parametrize("block_b", [32, 64, 1024])
def test_split_gain_kernel_pinned_block(dev, b, c, block_b):
    """A pinned ``block_b`` (threads a block, one row a warp) launches the
    register kernel (two classes) and the shared-memory one alike."""
    from repro_torch.kernels import ref, split_gain
    rng = np.random.default_rng(b + block_b)
    k, a = 40, 5
    hist = torch.as_tensor(rng.integers(0, 5, (k, a, b, c)).astype(
        np.float32), device=dev)
    tw = hist.sum((1, 2, 3)) / a
    cont = torch.as_tensor(np.arange(a) % 2 == 0, device=dev)
    nb = torch.as_tensor(np.full(a, b, np.int32), device=dev)
    s_k, b_k = split_gain.split_gain(hist, tw, cont, nb, block_b=block_b)
    s_r, b_r = ref.split_gain_ref(hist, tw, cont, nb)
    assert torch.equal(b_k, b_r)
    fin = torch.isfinite(s_r)
    assert torch.equal(fin, torch.isfinite(s_k))
    assert torch.all((s_k[fin] - s_r[fin]).abs()
                     <= 1e-5 * (1 + s_r[fin].abs()))


def test_build_cuda_equals_torch_on_the_card(dev):
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.tree import trees_equal
    from repro_torch.data import datasets
    from repro_torch.kernels import histogram, split_gain
    for name, scale in (("census_pums", 0.01), ("syd10m9a", 0.001)):
        ds = datasets.load(name, scale=scale, max_bins=64)
        cfg = GrowConfig(max_nodes=1 << 14, frontier_slots=64)
        h0, g0 = histogram.LAUNCHES, split_gain.LAUNCHES
        t_cuda = frontier.build(ds, cfg)
        assert histogram.LAUNCHES > h0 and split_gain.LAUNCHES > g0
        t_torch = frontier.build(ds, cfg, impl="torch", device=dev)
        assert trees_equal(t_cuda, t_torch)


def _clone_state(state):
    from repro_torch.core import frontier
    tree = dataclasses.replace(state.tree, **{
        f.name: getattr(state.tree, f.name).clone()
        for f in dataclasses.fields(state.tree)})
    return frontier.GrowState(
        tree=tree, **{f: getattr(state, f).clone() for f in (
            "status", "active", "case_node", "n_nodes", "overflow")})


def _split_post_both(state, pre, att, x, cont, nb, prob):
    """The plain splitPost and the CUDA one from two copies of ``state``:
    each one's ``(state, stats)``.  The CUDA one launches two kernels."""
    from repro_torch.core import frontier
    from repro_torch.kernels import split_post
    plain = frontier.split_post(_clone_state(state), pre, att, x, cont, nb,
                                prob=prob)
    before = split_post.LAUNCHES
    got = frontier.split_post(_clone_state(state), pre, att, x, cont, nb,
                              prob=prob, impl="cuda")
    torch.cuda.synchronize()
    assert split_post.LAUNCHES == before + 2
    return plain, got


def _assert_same_post(plain, got, m):
    """Every node array, status, active row below the dump row M, every
    case's node, n_nodes, overflow and statistic exactly equal."""
    (want, want_stats), (state, stats) = plain, got
    for f in ("node_attr", "node_split_bin", "node_child0", "node_nchild",
              "node_class", "node_freq", "node_depth"):
        assert torch.equal(getattr(state.tree, f)[:m],
                           getattr(want.tree, f)[:m]), f
    for f in ("status", "active"):
        assert torch.equal(getattr(state, f)[:m], getattr(want, f)[:m]), f
    assert torch.equal(state.case_node, want.case_node)
    assert int(state.n_nodes) == int(want.n_nodes)
    assert int(state.tree.n_nodes) == int(want.n_nodes)
    assert bool(state.overflow) == bool(want.overflow)
    assert list(stats) == list(want_stats)
    assert {k: v.item() for k, v in stats.items()} == {
        k: v.item() for k, v in want_stats.items()}


def _post_walk_dataset(name):
    from _frontier_sets import kdd_like
    from repro_torch.data import datasets
    if name == "kdd_like":
        return kdd_like(20_000, 7)
    name, scale = {"syd": ("syd10m9a", 0.001),
                   "census": ("census_pums", 0.01),
                   "waveform40": ("waveform40", 0.002)}[name]
    return datasets.load(name, scale=scale, max_bins=64)


@pytest.mark.parametrize("name,max_nodes,slots", [
    ("syd", 1 << 12, 64), ("syd", 1 << 12, 8), ("kdd_like", 1 << 12, 32),
    ("census", 1 << 14, 64), ("syd", 200, 16), ("kdd_like", 300, 64)],
    ids=["syd", "syd-8-slots", "kdd_like", "census", "syd-capacity",
         "kdd_like-capacity"])
def test_split_post_kernels_equal_plain_every_superstep(dev, name, max_nodes,
                                                        slots):
    """Every superstep of a build, the CUDA splitPost against the plain
    one from the same (state, pre, att): SyD's shapes (C 2, H 20, A 9), a
    KDD-like C 23, H 70, A 41, census_pums; supersteps with fewer open
    nodes than slots (invalid slots write the dump row), more open nodes
    than slots, cases of slot -1, unknown bins, discrete attributes
    retired, and the capacity hit (overflow)."""
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    ds = _post_walk_dataset(name)
    cfg = GrowConfig(max_nodes=max_nodes, frontier_slots=slots)
    prob = frontier.FrontierProblem.from_dataset(ds, cfg)
    x = torch.as_tensor(ds.x, dtype=torch.int32, device=dev)
    y = torch.as_tensor(ds.y, dtype=torch.int32, device=dev)
    w = torch.as_tensor(ds.w, dtype=torch.float32, device=dev)
    cont = torch.as_tensor(ds.attr_is_cont, device=dev)
    nb = torch.as_tensor(ds.n_bins, dtype=torch.int32, device=dev)
    state = frontier.init_state(prob, y, w)
    seen = dict(short=False, full=False, unknown=False, closed=False,
                retired=False, overflow=False)
    steps = 0
    while bool(torch.any(state.status[:max_nodes] == 1)):
        pre = frontier.split_pre(state, prob=prob)
        att = frontier.split_att(state, pre, x, y, w, cont, nb, prob=prob,
                                 impl="cuda")
        plain, got = _split_post_both(state, pre, att, x, cont, nb, prob)
        _assert_same_post(plain, got, max_nodes)
        state = plain[0]
        live = pre["slot"] >= 0
        seen["short"] |= pre["n_open"] < slots
        seen["full"] |= pre["n_open"] == slots
        seen["unknown"] |= bool((x[live] < 0).any())
        seen["closed"] |= bool((~live).any())
        seen["retired"] |= bool((~state.active[:max_nodes][
            state.status[:max_nodes] == 1]).any())
        seen["overflow"] |= bool(state.overflow)
        steps += 1
    capped = max_nodes < 1000
    assert steps > 1 and seen["short"] and seen["closed"], seen
    assert seen["retired"] or capped, seen
    assert seen["unknown"] or name != "kdd_like", seen
    assert seen["overflow"] or not capped, seen
    assert seen["full"] or slots == 64, seen


@pytest.mark.parametrize("name,max_nodes,slots", [
    ("syd", 1 << 12, 64), ("syd", 1 << 12, 8), ("kdd_like", 1 << 12, 32),
    ("census", 1 << 14, 64), ("syd", 200, 16), ("kdd_like", 300, 64),
    ("waveform40", 1 << 12, 32)],
    ids=["syd", "syd-8-slots", "kdd_like", "census", "syd-capacity",
         "kdd_like-capacity", "waveform40"])
def test_open_range_next_frontier_equals_plain_split_pre(dev, name,
                                                         max_nodes, slots):
    """Every superstep of the ``cuda`` build's loop, the frontier that
    splitPost's kernels wrote (``ids``, ``valid``, ``ids_safe``,
    ``total_w``, ``depth_k``, ``pre_leaf``, each case's slot, and
    ``n_open`` from the loop's read of the range) equals the plain
    ``split_pre`` on the same state exactly, a slot of -2 (a closed
    node's case) reading as the plain -1; the cases of
    ``test_split_post_kernels_equal_plain_every_superstep`` and
    Waveform-40 (C 3, A 40).  The build's tree equals
    ``build(impl="torch")``'s."""
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.tree import trees_equal
    from repro_torch.obs.trace import NULL
    ds = _post_walk_dataset(name)
    cfg = GrowConfig(max_nodes=max_nodes, frontier_slots=slots)
    prob = frontier.FrontierProblem.from_dataset(ds, cfg)
    from _frontier_sets import as_tensors
    x, y, w, cont, nb = as_tensors(ds, dev)
    state = frontier.init_state(prob, y, w, open_range=True)
    seen = dict(waiting=False, closed=False, short=False)
    steps = 0
    while frontier._open_left(state, cfg, NULL):
        pre = frontier.split_pre(state, prob=prob)
        want = frontier.split_pre(dataclasses.replace(state, open_range=None),
                                  prob=prob)
        assert pre["n_open"] == want["n_open"], steps
        for key in ("ids", "valid", "ids_safe", "total_w", "depth_k",
                    "pre_leaf"):
            assert pre[key].dtype == want[key].dtype, key
            assert torch.equal(pre[key], want[key]), (key, steps)
        slot = pre["slot"]
        assert torch.equal(torch.where(slot < 0, -1, slot), want["slot"]), \
            steps
        seen["waiting"] |= bool((slot == -1).any())
        seen["closed"] |= bool((slot == -2).any())
        seen["short"] |= pre["n_open"] < slots
        att = frontier.split_att(state, pre, x, y, w, cont, nb, prob=prob,
                                 impl="cuda")
        state, _ = frontier.split_post(state, pre, att, x, cont, nb,
                                       prob=prob, impl="cuda")
        steps += 1
    assert steps > 1 and seen["closed"] and seen["short"], seen
    assert seen["waiting"] or slots == 64, seen
    assert trees_equal(frontier.build(ds, cfg),
                       frontier.build(ds, cfg, impl="torch", device=dev))


def test_split_pre_of_an_open_range_launches_nothing(dev):
    """Under ``torch.profiler``, ``split_pre`` on the ``cuda`` build's state
    (the loop's test has read the range) records no torch op and nothing
    on the card: no kernel, no copy, no fill.  The plain ``split_pre`` on
    the same state records its launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.obs.trace import NULL
    ds = _post_walk_dataset("syd")
    cfg = GrowConfig(max_nodes=1 << 12, frontier_slots=16)
    prob = frontier.FrontierProblem.from_dataset(ds, cfg)
    from _frontier_sets import as_tensors
    x, y, w, cont, nb = as_tensors(ds, dev)
    state = frontier.init_state(prob, y, w, open_range=True)
    for _ in range(4):
        assert frontier._open_left(state, cfg, NULL)
        pre = frontier.split_pre(state, prob=prob)
        att = frontier.split_att(state, pre, x, y, w, cont, nb, prob=prob,
                                 impl="cuda")
        state, _ = frontier.split_post(state, pre, att, x, cont, nb,
                                       prob=prob, impl="cuda")
    assert frontier._open_left(state, cfg, NULL)
    torch.cuda.synchronize()

    def recorded(fn):
        """The torch ops and the card's events of ``fn``."""
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        events = prof.events()
        return ([e.name for e in events if e.name.startswith("aten::")],
                [e.name for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA])
    ops, card = recorded(lambda: frontier.split_pre(state, prob=prob))
    assert ops == [] and card == [], (ops, card)
    ops, card = recorded(lambda: frontier.split_pre(
        dataclasses.replace(state, open_range=None), prob=prob))
    assert ops and card, (ops, card)


@pytest.mark.parametrize("name,max_nodes,slots", [
    ("syd", 1 << 12, 64), ("syd", 1 << 12, 8), ("waveform40", 1 << 12, 32)],
    ids=["syd", "syd-8-slots", "waveform40"])
def test_routing_kernel_lists_the_next_live_cases(dev, name, max_nodes,
                                                  slots):
    """Every superstep of the ``cuda`` build's loop, from the root to the
    last, whose next frontier holds no case: the list splitPost's routing
    kernel wrote holds, as a set, exactly the cases of next slot >= 0
    (``nonzero``), each once, and the range's third word (what the loop's
    test reads as ``n_live``) is their count; the histogram of the next
    superstep reads its cases through that list (``SOURCES["list"]``)."""
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.kernels import histogram
    from repro_torch.obs.trace import NULL
    from _frontier_sets import as_tensors
    ds = _post_walk_dataset(name)
    cfg = GrowConfig(max_nodes=max_nodes, frontier_slots=slots)
    prob = frontier.FrontierProblem.from_dataset(ds, cfg)
    x, y, w, cont, nb = as_tensors(ds, dev)
    state = frontier.init_state(prob, y, w, open_range=True)
    counts = []
    steps = 0
    while frontier._open_left(state, cfg, NULL):
        rng = state.open_range
        assert rng.listed == (steps > 0)
        pre = frontier.split_pre(state, prob=prob)
        before = histogram.SOURCES["list"]
        att = frontier.split_att(state, pre, x, y, w, cont, nb, prob=prob,
                                 impl="cuda")
        assert histogram.SOURCES["list"] - before == (
            steps > 0 and rng.n_live > 0)
        state, _ = frontier.split_post(state, pre, att, x, cont, nb,
                                       prob=prob, impl="cuda")
        nxt = state.open_range
        n_live = int(nxt.bounds[2])
        want = torch.nonzero(nxt.pre["slot"] >= 0).flatten()
        got = nxt.live[:n_live].long()
        assert n_live == want.numel(), steps
        assert torch.equal(torch.sort(got).values, want), steps
        assert nxt.live is rng.live and nxt.listed
        counts.append(n_live)
        steps += 1
    assert steps > 5 and counts[-1] == 0 and max(counts) > 0, counts
    assert any(0 < v < ds.n_cases for v in counts), counts


@pytest.mark.parametrize("model", ["alpha", "nlogn", "nsq"])
@pytest.mark.parametrize("k,a,b,c,h,spare", [
    (64, 9, 64, 2, 20, 500), (32, 41, 70, 23, 70, 2000), (5, 3, 4, 3, 4, 40),
    (256, 9, 256, 2, 20, 3)],
    ids=["syd", "kdd_like", "small", "capacity"])
def test_split_post_kernels_equal_plain_on_random_planes(dev, k, a, b, c, h,
                                                         spare, model):
    """Random splitPre / splitAtt planes with many ties (small integral
    counts: equal children's weights, equal class counts), invalid slots,
    unknown bins, cases of slot -1 and of unsplit nodes, each cost model;
    ``spare`` rows short of the capacity (3: the superstep overflows)."""
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.tree import Tree
    rng = np.random.default_rng(k * a + c)
    n, m = 30_000, 4096
    cfg = GrowConfig(max_nodes=m, frontier_slots=k, cost_model=model,
                     alpha=40.0)
    cont_np = np.arange(a) % 3 != 2
    nb_np = np.where(cont_np, b, rng.integers(1, h + 1, a)).astype(np.int32)
    nb_np[np.flatnonzero(~cont_np)[0]] = h        # the widest: H children
    prob = frontier.FrontierProblem(n_cases=n, n_attrs=a, n_bins_max=b,
                                    n_classes=c, max_children=h, cfg=cfg)
    n0 = m - spare
    tree = Tree.empty(m + 1, c, dev)
    tree.node_class[:] = torch.as_tensor(rng.integers(0, c, m + 1),
                                         dtype=torch.int32, device=dev)
    n_open = k - k // 4
    ids = np.sort(rng.choice(n0, n_open, replace=False))
    state = frontier.GrowState(
        tree=tree,
        status=torch.full((m + 1,), 2, dtype=torch.int32, device=dev),
        active=torch.as_tensor(rng.random((m + 1, a)) < 0.8, device=dev),
        case_node=torch.as_tensor(rng.integers(0, n0, n), dtype=torch.int32,
                                  device=dev),
        n_nodes=torch.tensor(n0, dtype=torch.int32, device=dev),
        overflow=torch.tensor(False, device=dev))
    ids_t = torch.full((k,), m, dtype=torch.int64, device=dev)
    ids_t[:n_open] = torch.as_tensor(ids, device=dev)
    valid = ids_t < m
    slot = rng.integers(-1, k, n).astype(np.int32)
    slot[slot >= n_open] = -1
    pre = dict(
        ids=ids_t, n_open=n_open, valid=valid,
        ids_safe=torch.clamp_max(ids_t, m - 1),
        slot=torch.as_tensor(slot, device=dev),
        total_w=torch.as_tensor(rng.integers(0, 200, k), dtype=torch.float32,
                                device=dev) * valid,
        depth_k=torch.as_tensor(rng.integers(0, 9, k), dtype=torch.int32,
                                device=dev),
        pre_leaf=torch.as_tensor(rng.random(k) < 0.2, device=dev))
    hist_u = torch.as_tensor(rng.integers(0, 3, (k, a, b + 1, c)) * (
        rng.random((k, a, b + 1, c)) < 0.5), dtype=torch.float32, device=dev)
    split_bin = np.where(cont_np[None, :], rng.integers(-1, b - 1, (k, a)),
                         -1).astype(np.int32)
    active_k = torch.as_tensor(rng.random((k, a)) < 0.7, device=dev) & valid[
        :, None]
    att = dict(hist=hist_u[:, :, :b], unknown=hist_u[:, :, b],
               split_bin=torch.as_tensor(split_bin, device=dev),
               active_k=active_k,
               best_attr=torch.as_tensor(rng.integers(0, a, k),
                                         dtype=torch.int32, device=dev),
               has_split=torch.as_tensor(rng.random(k) < 0.8, device=dev))
    x = np.stack([rng.integers(-1, nb_np[j], n) for j in range(a)], 1)
    x = torch.as_tensor(x.astype(np.int32), device=dev)
    cont = torch.as_tensor(cont_np, device=dev)
    nb = torch.as_tensor(nb_np, device=dev)
    plain, got = _split_post_both(state, pre, att, x, cont, nb, prob)
    _assert_same_post(plain, got, m)
    stats = plain[1]
    assert bool(stats["overflow"]) == (spare == 3)
    assert 0 < int(stats["n_active"]) < n
    if spare > 3:
        assert 0 < int(stats["n_internal"]) < n_open


def test_split_post_launches_two_a_superstep(dev):
    """A whole build(impl="cuda") on census_pums equals build(impl="torch")
    on the card, with the same statistics row by row, two splitPost
    launches a superstep and none on the torch build."""
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.tree import trees_equal
    from repro_torch.data import datasets
    from repro_torch.kernels import split_post
    ds = datasets.load("census_pums", scale=0.01, max_bins=64)
    cfg = GrowConfig(max_nodes=1 << 14, frontier_slots=64)
    before = split_post.LAUNCHES
    tree, rows = frontier.build(ds, cfg, collect_stats=True)
    assert split_post.LAUNCHES - before == 2 * len(rows)
    before = split_post.LAUNCHES
    want, want_rows = frontier.build(ds, cfg, impl="torch", device=dev,
                                     collect_stats=True)
    assert split_post.LAUNCHES == before
    assert trees_equal(tree, want)
    assert rows == want_rows


def test_traced_build_equals_untraced_on_the_card(dev):
    """frontier.build(impl="cuda") with an enabled tracer (spans that add
    no wait for the card) grows the untraced tree, with a span of each
    phase, each wait and each kernel call a superstep (``wait.status``
    once, the root's; no ``wait.frontier``: splitPre reads the frontier
    splitPost's kernels wrote; no ``wait.compact``: the histogram reads the
    live cases through the list they wrote, a ``compact`` span a superstep
    around the handoff), and a histogram and split-gain launch and two
    splitPost launches each superstep, the histogram's through the list
    past the root; the registry holds the frontier's counters and gauges
    and no ``frontier_phase_seconds``."""
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.tree import trees_equal
    from repro_torch.data import datasets
    from repro_torch.kernels import histogram, split_gain, split_post
    from repro_torch.obs import Registry, Tracer
    ds = datasets.load("census_pums", scale=0.01, max_bins=64)
    cfg = GrowConfig(max_nodes=1 << 14, frontier_slots=64)
    plain = frontier.build(ds, cfg, impl="cuda")
    tr, reg = Tracer(), Registry()
    h0, g0, p0 = histogram.LAUNCHES, split_gain.LAUNCHES, split_post.LAUNCHES
    s0 = dict(histogram.SOURCES)
    traced, rows = frontier.build(ds, cfg, impl="cuda", collect_stats=True,
                                  tracer=tr, metrics=reg)
    assert trees_equal(plain, traced)
    summ = tr.span_summary()
    for span in ("superstep", "splitPre", "splitAtt", "splitPost",
                 "compact", "kernel.histogram", "kernel.split_gain",
                 "kernel.split_post"):
        assert summ[span]["count"] == len(rows), span
    assert summ["wait.loop"]["count"] == len(rows) + 1
    # splitPre reads the frontier splitPost's kernels wrote, the histogram
    # the live cases they listed: no wait for either
    assert "wait.frontier" not in summ and "wait.compact" not in summ
    # the root's status write alone: the CUDA splitPost writes none
    for span in ("entry.copy", "entry.init", "wait.stats", "wait.status"):
        assert summ[span]["count"] == 1, span
    assert split_gain.LAUNCHES - g0 == len(rows)
    assert split_post.LAUNCHES - p0 == 2 * len(rows)
    assert histogram.LAUNCHES - h0 == sum(r["n_active"] > 0 for r in rows)
    assert histogram.SOURCES["rows"] - s0["rows"] == 1      # the root
    assert histogram.SOURCES["list"] - s0["list"] == sum(
        r["n_active"] > 0 for r in rows[1:])
    assert "frontier_phase_seconds" not in reg.snapshot()
    assert set(reg.snapshot()) == {
        "frontier_supersteps_total", "frontier_active_cases",
        "frontier_open_nodes", "frontier_nap_nodes_total",
        "frontier_children_total"}


def test_tracer_adds_one_synchronising_call_a_build(dev, monkeypatch):
    """Synchronising calls of one build, counted by torch's sync debug mode
    ("warn": a warning each, at the line of the port that made it) plus
    any explicit ``torch.cuda.synchronize``: with an enabled Tracer and no
    stats a build makes exactly one more than the untraced build of the
    same tree, the one read of the statistics after the loop, and the
    same calls at every other line.  Past the entry's copies of the rows
    (``build``'s own lines) the untraced build makes exactly N + 2, at
    the traced ``wait.*`` spans' lines: the loop's N + 1 reads of the open
    range and its live count, the root's status write.  splitPre,
    splitAtt's compaction and splitPost make none: no call in their lines
    nor in the compaction's module or splitPost's kernels' wrapper."""
    import collections
    import inspect
    import warnings
    from pathlib import Path

    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.tree import trees_equal
    from repro_torch.data import datasets
    from repro_torch.obs import Registry, Tracer
    port = str(Path(frontier.__file__).resolve().parents[1])
    ds = datasets.load("census_pums", scale=0.01, max_bins=64)
    cfg = GrowConfig(max_nodes=1 << 14, frontier_slots=64)
    frontier.build(ds, cfg, impl="cuda")          # the kernels load
    torch.cuda.synchronize(dev)
    explicit = [0]
    real_sync = torch.cuda.synchronize

    def counted_sync(*args, **kw):
        explicit[0] += 1
        return real_sync(*args, **kw)

    def synchronising(tracer):
        """The build's tree, and its synchronising calls by (file, line)
        of the port ("synchronize": the explicit ones)."""
        explicit[0] = 0
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                tree = frontier.build(ds, cfg, impl="cuda", tracer=tracer,
                                      metrics=Registry() if tracer else None)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        sites = collections.Counter(
            (Path(w.filename).name, w.lineno) for w in caught
            if "synchroniz" in str(w.message)
            and str(Path(w.filename).resolve()).startswith(port))
        sites["synchronize"] = explicit[0]
        return tree, +sites

    monkeypatch.setattr(torch.cuda, "synchronize", counted_sync)
    plain, untraced = synchronising(None)
    tr = Tracer()
    traced, with_tracer = synchronising(tr)
    assert trees_equal(plain, traced)
    n_steps = tr.span_summary()["superstep"]["count"]
    extra = with_tracer - untraced
    assert not untraced - with_tracer, (untraced, with_tracer)
    assert sum(extra.values()) == 1, extra
    assert next(iter(extra))[0] == "frontier.py", extra

    def lines(fn):
        src, start = inspect.getsourcelines(fn)
        return range(start, start + len(src))
    entry = lines(frontier.build)
    quiet = [*lines(frontier.split_pre), *lines(frontier.split_post),
             *lines(frontier._split_post_cuda)]
    assert not [site for site in untraced
                if site[0] in ("split_post.py", "compaction.py")
                or site[0] == "frontier.py" and site[1] in quiet], untraced
    waits = sum(n for (f, line), n in untraced.items()
                if f == "frontier.py" and line not in entry)
    assert waits == n_steps + 2, (untraced, n_steps)


def test_concurrent_builds_from_threads(dev):
    """4 frontier.build(impl="cuda") at once from threads, as the farm's
    workers launch them: three classes and B = 320 .. 1,024 bins put split
    gain on its shared-memory kernel with an opt-in of 34-101 KB that
    differs between the threads.  Each tree equals its build alone, and
    the launch counts (histogram, split gain, splitPost) are the lone
    builds' sum exactly."""
    import threading

    from repro_torch.core import binning, frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.tree import trees_equal
    from repro_torch.kernels import autotune, histogram, split_gain, split_post
    cfg = GrowConfig(max_nodes=1 << 12, frontier_slots=32)
    sets = []
    for i, b in enumerate((320, 512, 768, 1024)):
        rng = np.random.default_rng(i)
        x = np.stack([rng.integers(-1, b, 20_000),
                      rng.integers(-1, b, 20_000),
                      rng.integers(-1, 6, 20_000)], axis=1)
        y = (x[:, 0] * 3 // b + rng.integers(0, 2, 20_000)) % 3
        sets.append(binning.from_binned(
            x, y, attr_is_cont=[True, True, False], n_bins=[b, b, 6],
            n_classes=3))
        assert not autotune.plan_split_gain(n_bins=b, n_classes=3).regs
    def launches():
        return histogram.LAUNCHES, split_gain.LAUNCHES, split_post.LAUNCHES
    alone, counts = [], []
    for ds in sets:
        before = launches()
        alone.append(frontier.build(ds, cfg, impl="cuda"))
        counts.append(tuple(n - b for n, b in zip(launches(), before)))
    got, errors = [None] * len(sets), []
    start = threading.Barrier(len(sets))

    def grow(i):
        try:
            start.wait()
            got[i] = frontier.build(sets[i], cfg, impl="cuda")
        except BaseException as e:       # surfaced below
            errors.append(e)
    before = launches()
    threads = [threading.Thread(target=grow, args=(i,))
               for i in range(len(sets))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert not errors, errors
    for a, b in zip(alone, got):
        assert trees_equal(a, b)
    assert tuple(n - b for n, b in zip(launches(), before)) == tuple(
        map(sum, zip(*counts)))


# (T, M, A, N): a lone root leaf, N = 1 and 257 (off every block), a random
# 4-tree forest, wider tables up to 2^14 rows; 70,000 lone leaves and
# small trees (past the 65,535 trees of a grid's y dimension); A = 2,000
# (bins far apart in a case's row)
INFER_SHAPES = [(1, 1, 3, 1), (1, 1, 9, 257), (4, 64, 9, 1), (4, 64, 9, 257),
                (4, 500, 6, 10_000), (3, 3000, 40, 5_000),
                (2, 1 << 14, 9, 100_003), (70_000, 7, 9, 65),
                (4, 500, 2000, 300)]


def _infer_matches_plain(tab, x, cont, depth, block_n):
    """One launch equals the plain version exactly and is counted, in
    LAUNCHES and under its plan in PLANS."""
    from repro_torch.kernels import autotune, ref, tree_infer
    t, _, _ = tab.shape
    n = x.shape[0]
    mode = autotune.plan_infer_blocks(n_cases=n, n_trees=t,
                                      block_n=block_n).mode
    before, plans = tree_infer.LAUNCHES, dict(tree_infer.PLANS)
    got = tree_infer.forest_predict(tab, x, cont, max_depth=depth,
                                    block_n=block_n)
    want = ref.forest_predict_ref(tab, x, cont, max_depth=depth)
    torch.cuda.synchronize()
    assert tree_infer.LAUNCHES == before + 1
    assert tree_infer.PLANS == {**plans, mode: plans[mode] + 1}
    assert got.dtype == torch.int32 and got.shape == (t, n)
    assert torch.equal(got, want)


def _infer_inputs(dev, t, m, a, n, *, shuffle=False):
    from _forest_tables import random_cases, random_forest_table, \
        shuffle_node_ids
    rng = np.random.default_rng(t * m + a)
    cont = rng.random(a) < 0.5
    tab, levels = random_forest_table(rng, t, m, cont, n_bins=16,
                                      max_children=8, leaf_p=0.1)
    if shuffle:
        tab = shuffle_node_ids(rng, tab)
    x = random_cases(rng, n, cont, n_bins=16)
    tab, x, cont = (torch.as_tensor(v, device=dev) for v in (tab, x, cont))
    return tab, x, cont, levels


@pytest.mark.parametrize("t,m,a,n", INFER_SHAPES)
@pytest.mark.parametrize("block_n", [None, 32, 1024])
def test_forest_predict_kernel_matches_plain(dev, t, m, a, n, block_n):
    tab, x, cont, levels = _infer_inputs(dev, t, m, a, n)
    for depth in (levels, min(levels, 2)):
        _infer_matches_plain(tab, x, cont, depth, block_n)


# every block of the plan pinned once, on a breadth-first table and on one
# with shuffled ids (children contiguous, the low ids not the top levels)
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("block_n", [32, 64, 128, 256, 512, 1024])
def test_forest_predict_every_plan_matches_plain(dev, block_n, shuffle):
    tab, x, cont, levels = _infer_inputs(dev, 5, 3000, 9, 4099,
                                         shuffle=shuffle)
    for depth in (levels, 3, 0):
        _infer_matches_plain(tab, x, cont, depth, block_n)


def test_forest_predict_cuda_equals_torch_on_the_card(dev):
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.data import datasets
    from repro_torch.infer import forest as F
    from repro_torch.kernels import tree_infer
    ds = datasets.load("census_pums", scale=0.01, max_bins=64)
    cfg = GrowConfig(max_nodes=1 << 12, frontier_slots=64)
    rng = np.random.default_rng(0)
    trees = [frontier.build(ds, cfg, case_w=rng.integers(0, 3, ds.n_cases))
             for _ in range(3)]
    fo = F.Forest.pack(trees, weights=rng.uniform(0.5, 2, 3))
    x = ds.x.copy()
    x[rng.random(x.shape) < 0.05] = -1
    before = tree_infer.LAUNCHES
    got = F.predict(fo, x, ds.attr_is_cont)
    assert tree_infer.LAUNCHES == before + 1
    assert torch.equal(got, F.predict(fo, x, ds.attr_is_cont, impl="torch"))
    assert torch.equal(F.predict_per_tree(fo, x, ds.attr_is_cont),
                       F.predict_per_tree(fo, x, ds.attr_is_cont, impl="ref"))


# (B, S, H, KV, D, window, softcap, dtype): the six cases of the JAX
# package's tests/test_kernels.py, then gemma2's and yi's head dims at
# ragged lengths (one tile, one row past it, a lone row, many tiles)
FLASH_CASES = [
    (2, 24, 4, 2, 16, 0, 0.0, "float32"),
    (1, 33, 4, 4, 8, 0, 0.0, "float32"),
    (2, 24, 4, 2, 16, 7, 0.0, "float32"),
    (2, 24, 4, 2, 16, 0, 30.0, "float32"),
    (2, 40, 6, 2, 32, 9, 50.0, "float32"),
    (2, 32, 4, 2, 16, 0, 0.0, "bfloat16"),
] + [(1, s, 4, 2, d, w, 50.0, dt)
     for d in (128, 256) for s in (1, 63, 65, 1000)
     for w, dt in ((0, "float32"), (100, "bfloat16"))]
# f32: another summation order than the plain version's matmuls (which run
# in full f32: TF32 is off); bf16: one rounding step of outputs near 1
FLASH_TOL = {"float32": 3e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(dev, case):
    from repro_torch.kernels import flash_attention, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, d, window, cap, dtype = case
    rng = np.random.default_rng(b * s + d)
    dt = getattr(torch, dtype)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32),
                               device=dev).to(dt)
               for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d)))
    before = flash_attention.LAUNCHES
    got = flash_attention.flash_attention(q, k, v, window=window,
                                          softcap=cap)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES == before + 1
    assert got.dtype == dt and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[dtype], rtol=0)


def _flash_inputs(dev, b, s, h, kv, d, dt, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(0, 1, shape).astype(np.float32),
                            device=dev).to(dt)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("d", [8, 16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("s", [1, 63, 65, 127, 129, 1000])
@pytest.mark.parametrize("b", [1, 2])
def test_flash_tensor_core_kernel_matches_plain(dev, b, s, d, window,
                                                softcap):
    """The bf16 wgmma kernel: ragged S on both sides of the 64-key and
    128-query tiles, B = 2 (the tensor map's batch edge), D below one
    64-column box, across a partly filled one, and up to four of them."""
    from repro_torch.kernels import flash_attention, ref
    q, k, v = _flash_inputs(dev, b, s, 4, 2, d, torch.bfloat16, b * s + d)
    before = dict(flash_attention.LAUNCHES_BY_DTYPE)
    got = flash_attention.flash_attention(q, k, v, window=window,
                                          softcap=softcap)
    want = ref.flash_attention_ref(q, k, v, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES_BY_DTYPE == {
        "bfloat16": before["bfloat16"] + 1, "float32": before["float32"]}
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL["bfloat16"], rtol=0)


def test_flash_routes_each_dtype_to_its_kernel(dev):
    """bf16 launches the tensor-core kernel, f32 the scalar one; both count
    in LAUNCHES, each in its own LAUNCHES_BY_DTYPE entry."""
    from repro_torch.kernels import flash_attention, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    for dt, name in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        q, k, v = _flash_inputs(dev, 2, 129, 4, 2, 128, dt, 7)
        total = flash_attention.LAUNCHES
        before = dict(flash_attention.LAUNCHES_BY_DTYPE)
        got = flash_attention.flash_attention(q, k, v, window=100,
                                              softcap=50.0)
        torch.cuda.synchronize()
        assert flash_attention.LAUNCHES == total + 1
        want = {n: c + (n == name) for n, c in before.items()}
        assert flash_attention.LAUNCHES_BY_DTYPE == want
        torch.testing.assert_close(
            got.float(), ref.flash_attention_ref(
                q, k, v, window=100, softcap=50.0).float(),
            atol=FLASH_TOL[name], rtol=0)


def test_flash_bf16_launch_failure_raises(dev):
    """A geometry the bf16 kernel was not built for is refused by the
    launch, and the wrapper raises: nothing falls back."""
    from repro_torch.kernels import flash_attention
    q, k, v = _flash_inputs(dev, 1, 64, 2, 1, 64, torch.bfloat16, 3)
    real = flash_attention.tma_geometry
    flash_attention.tma_geometry = lambda *a: dataclasses.replace(
        real(*a), smem_bytes=real(*a).smem_bytes - 16)
    try:
        before = flash_attention.LAUNCHES
        with pytest.raises(RuntimeError, match="launch failed"):
            flash_attention.flash_attention(q, k, v)
        assert flash_attention.LAUNCHES == before
    finally:
        flash_attention.tma_geometry = real


def test_lm_prefill_cuda_equals_torch_on_the_card(dev):
    """Reduced gemma2 (window 64, softcaps) in f32: prefill through the
    kernel equals prefill through the plain attention on the card."""
    from repro_torch.configs import base
    from repro_torch.kernels import flash_attention
    from repro_torch.models.model import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = base.reduced(base.get_config("gemma2_9b"), dtype="float32")
    gen = torch.Generator(dev).manual_seed(0)
    params = build_model(cfg).init(gen)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (2, 100)), device=dev)
    before = flash_attention.LAUNCHES
    got, cache = build_model(cfg).prefill(params, tokens, max_seq=128)
    assert flash_attention.LAUNCHES == before + cfg.n_layers
    want, cache_t = build_model(cfg, impl="torch").prefill(params, tokens,
                                                           max_seq=128)
    assert flash_attention.LAUNCHES == before + cfg.n_layers
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    for a, b in zip(cache, cache_t):
        torch.testing.assert_close(a["k"], b["k"], atol=1e-4, rtol=0)


# The backward kernels (csrc/flash_attention_bwd.cu) against the plain
# backward on the same inputs: f32 atol 2e-4 (another summation order;
# chip_smoke.py measured at most 3.9e-5 on an H100); bf16 within 1% of the
# largest plain gradient (both round their f32 sums to bf16, a relative
# step of 2^-8, and the tensor-core kernels round P and dS to bf16 as
# operands; chip_smoke.py measured at most 0.25 absolute).
BWD_CASES = [c[:7] for c in FLASH_CASES[:6]] + [
    (1, s, 4, 2, d, w, cap) for d in (64, 128, 256) for s in (1, 63, 65, 1000)
    for w, cap in ((0, 0.0), (100, 50.0))] + [
    (2, 129, 6, 2, 32, 31, 0.0), (2, 200, 3, 1, 40, 1, 30.0)]


def _bwd_inputs(dev, b, s, h, kv, d, dt, seed):
    from repro_torch.kernels import flash_attention
    q, k, v = _flash_inputs(dev, b, s, h, kv, d, dt, seed)
    do = _flash_inputs(dev, b, s, h, kv, d, dt, seed + 1)[0]
    return flash_attention.scale_query(q), k, v, do


def _bwd_close(got, want, dtype):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        tol = (2e-4 if dtype == torch.float32
               else 1e-2 * max(w.float().abs().max().item(), 1.0))
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_backward_kernel_matches_plain(dev, case, dtype):
    from repro_torch.kernels import flash_attention, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, d, window, cap = case
    qs, k, v, do = _bwd_inputs(dev, b, s, h, kv, d, dtype, b * s + d)
    kw = dict(window=window, softcap=cap)
    o, lse = flash_attention.flash_attention_fwd(qs, k, v, with_lse=True,
                                                 **kw)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    before = dict(flash_attention.LAUNCHES_BWD_BY_DTYPE)
    got = flash_attention.flash_attention_bwd(qs, k, v, o, do, lse, **kw)
    want = ref.flash_attention_bwd_ref(qs, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES_BWD_BY_DTYPE == {
        n: c + (n == name) for n, c in before.items()}
    _bwd_close(got, want, dtype)


def _bwd_against_plain(dev, b, s, h, kv, d, window, cap, seed):
    """The bf16 backward (tensor-core kernels) against the plain backward on
    the same inputs: one bf16 launch, no f32 one, within the bf16 gate."""
    from repro_torch.kernels import flash_attention, ref
    qs, k, v, do = _bwd_inputs(dev, b, s, h, kv, d, torch.bfloat16, seed)
    kw = dict(window=window, softcap=cap)
    o, lse = flash_attention.flash_attention_fwd(qs, k, v, with_lse=True,
                                                 **kw)
    before = dict(flash_attention.LAUNCHES_BWD_BY_DTYPE)
    got = flash_attention.flash_attention_bwd(qs, k, v, o, do, lse, **kw)
    want = ref.flash_attention_bwd_ref(qs, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES_BWD_BY_DTYPE == {
        "bfloat16": before["bfloat16"] + 1, "float32": before["float32"]}
    _bwd_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("d", range(8, 257, 8))
def test_flash_backward_tensor_core_every_head_dim(dev, d):
    """Every D the wrapper takes, 40, 96 and 200 (not multiples of 64)
    among them: S = 200 (not a multiple of the 64-row tile), B = 2 (the
    tensor map's batch edge), G = 1, 2, 3 in turn, with and without window
    and softcap."""
    g = (d // 8) % 3 + 1
    window, cap = ((0, 0.0), (50, 0.0), (0, 30.0), (70, 50.0))[(d // 8) % 4]
    _bwd_against_plain(dev, 2, 200, 2 * g, 2, d, window, cap, d)


@pytest.mark.parametrize("window,cap", [(0, 0.0), (1, 0.0), (100, 0.0),
                                        (0, 50.0), (100, 50.0)])
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("s,d", [(1, 256), (63, 64), (65, 40), (130, 96),
                                 (1000, 256), (777, 200)])
def test_flash_backward_tensor_core_groups_windows_softcaps(dev, s, d, g,
                                                            window, cap):
    """GQA groups of 1, 2 and 3 query heads, windows narrower than a tile
    and wider, the softcap, ragged S on both sides of the 64-row tile."""
    _bwd_against_plain(dev, 1, s, 2 * g, 2, d, window, cap, s + d + g)


def test_flash_backward_routes_each_dtype_to_its_kernels(dev):
    """bf16 inputs run the tensor-core kernels (flash_bwd_dkdv_wgmma,
    flash_bwd_dq_wgmma), f32 inputs the scalar ones (flash_bwd_dkdv,
    flash_bwd_dq), each after flash_bwd_delta: the kernels' names as the
    profiler records them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import flash_attention
    for dt, wgmma in ((torch.bfloat16, True), (torch.float32, False)):
        qs, k, v, do = _bwd_inputs(dev, 1, 300, 4, 2, 128, dt, 9)
        o, lse = flash_attention.flash_attention_fwd(qs, k, v, with_lse=True)
        flash_attention.flash_attention_bwd(qs, k, v, o, do, lse)
        torch.cuda.synchronize()
        names = set()
        for _ in range(3):          # the profiler may drop a kernel's events
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                flash_attention.flash_attention_bwd(qs, k, v, o, do, lse)
                torch.cuda.synchronize()
            names |= {e.key for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and "flash_bwd" in e.key}
            if len(names) == 3:
                break
        assert any("flash_bwd_delta" in n for n in names), names
        for part in ("flash_bwd_dkdv", "flash_bwd_dq"):
            hits = [n for n in names if part in n and "delta" not in n]
            assert hits and all(("wgmma" in n) == wgmma for n in hits), names


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_backward_kernel_is_bitwise_repeatable(dev, dtype):
    """No atomics: the same inputs give the same bits, launch after
    launch."""
    from repro_torch.kernels import flash_attention
    qs, k, v, do = _bwd_inputs(dev, 2, 1000, 6, 2, 128, dtype, 5)
    o, lse = flash_attention.flash_attention_fwd(qs, k, v, window=300,
                                                 with_lse=True)
    first = flash_attention.flash_attention_bwd(qs, k, v, o, do, lse,
                                                window=300)
    for _ in range(3):
        again = flash_attention.flash_attention_bwd(qs, k, v, o, do, lse,
                                                    window=300)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def test_flash_backward_tensor_core_repeats_at_the_layer_shape(dev):
    """The bf16 kernels at gemma3_4b's global layer (B 2, S 4,096, H 8,
    KV 4, D 256) and with window and softcap at D = 200: the same bits from
    launch to launch (dQ's two partials add in a fixed order)."""
    from repro_torch.kernels import flash_attention
    for b, s, h, kv, d, window, cap in ((2, 4096, 8, 4, 256, 0, 0.0),
                                        (1, 1500, 6, 2, 200, 300, 50.0)):
        qs, k, v, do = _bwd_inputs(dev, b, s, h, kv, d, torch.bfloat16, 5)
        kw = dict(window=window, softcap=cap)
        o, lse = flash_attention.flash_attention_fwd(qs, k, v, with_lse=True,
                                                     **kw)
        first = flash_attention.flash_attention_bwd(qs, k, v, o, do, lse,
                                                    **kw)
        again = flash_attention.flash_attention_bwd(qs, k, v, o, do, lse,
                                                    **kw)
        for a, b_ in zip(first, again):
            assert torch.equal(a, b_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES[:6] + FLASH_CASES[-4:])
def test_flash_forward_lse_matches_plain_and_keeps_the_output(dev, case,
                                                              dtype):
    """Writing the LSE changes no output bit; the LSE (natural log, the
    tensor-core kernel's log2 units converted) equals the plain one's."""
    from repro_torch.kernels import flash_attention, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, h, kv, d, window, cap, _ = case
    qs, k, v, _ = _bwd_inputs(dev, b, s, h, kv, d, dtype, b * s + d)
    kw = dict(window=window, softcap=cap)
    plain_out = flash_attention.flash_attention_fwd(qs, k, v, **kw)
    out, lse = flash_attention.flash_attention_fwd(qs, k, v, with_lse=True,
                                                   **kw)
    _, want = ref.flash_attention_fwd_ref(qs, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, s)
    torch.testing.assert_close(lse, want, atol=1e-4, rtol=0)


def test_attention_autograd_on_the_card_runs_the_kernel_pair(dev):
    """blockwise_attention under autograd on CUDA tensors: one forward and
    one backward launch, gradients equal to the plain pair's."""
    from repro_torch.kernels import flash_attention
    from repro_torch.models import layers
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = layers.AttnSpec(n_heads=6, n_kv_heads=2, head_dim=64, d_model=384,
                           window=50, softcap=30.0)
    q, k, v = _flash_inputs(dev, 2, 300, 6, 2, 64, torch.float32, 11)
    do = _flash_inputs(dev, 2, 300, 6, 2, 64, torch.float32, 12)[0]
    grads = {}
    for impl in ("cuda", "torch"):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        fwd, bwd = flash_attention.LAUNCHES, flash_attention.LAUNCHES_BWD
        out = layers.blockwise_attention(*leaves, spec=spec,
                                         impl=None if impl == "cuda" else impl)
        grads[impl] = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        n = int(impl == "cuda")
        assert flash_attention.LAUNCHES == fwd + n
        assert flash_attention.LAUNCHES_BWD == bwd + n
    for a, b in zip(grads["cuda"], grads["torch"]):
        torch.testing.assert_close(a, b, atol=2e-4, rtol=0)


def test_train_steps_launch_the_kernels_and_repeat_bitwise(dev):
    """Reduced gemma3_4b on the card (12 layers, two rematerialised
    cycles): each step runs the forward kernel twice a layer and the
    backward once, all bf16; a second run repeats every loss bit for bit."""
    from repro_torch.kernels import flash_attention
    from repro_torch.launch.train import train
    flash_attention.reset_launches()
    out = train("gemma3_4b", reduced=True, steps=3, global_batch=2,
                seq_len=128, log_every=100)
    assert flash_attention.LAUNCHES_BY_DTYPE == {"bfloat16": 3 * 24,
                                                 "float32": 0}
    assert flash_attention.LAUNCHES_BWD_BY_DTYPE == {"bfloat16": 3 * 12,
                                                     "float32": 0}
    again = train("gemma3_4b", reduced=True, steps=3, global_batch=2,
                  seq_len=128, log_every=100)
    assert out["history"] == again["history"]
    assert all(np.isfinite(out["history"]))


# The attention layers of the other LM architectures, at small S: GQA
# groups of 4, 5 and 7 query heads at D 128 (phi35_moe, llama4_scout,
# llava_next_34b), 10 over one KV head at D 256 with recurrentgemma_2b's
# window of 2,048 (and a window of 100, so that S = 300 is cut by it) and
# MHA at D 64 (musicgen_medium); (H, KV, D, window).
ARCH_GROUPS = {"phi35_moe": (32, 8, 128, 0), "llama4_scout": (40, 8, 128, 0),
               "llava_next_34b": (56, 8, 128, 0),
               "recurrentgemma_2b": (10, 1, 256, 2048),
               "recurrentgemma_2b_w100": (10, 1, 256, 100),
               "musicgen_medium": (24, 24, 64, 0)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [63, 300, 2100])
@pytest.mark.parametrize("arch", sorted(ARCH_GROUPS))
def test_flash_forward_at_the_arch_groups(dev, arch, s, dtype):
    from repro_torch.kernels import flash_attention, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    h, kv, d, window = ARCH_GROUPS[arch]
    q, k, v = _flash_inputs(dev, 1, s, h, kv, d, dtype, s + h)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    before = dict(flash_attention.LAUNCHES_BY_DTYPE)
    got = flash_attention.flash_attention(q, k, v, window=window)
    want = ref.flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES_BY_DTYPE == {
        n: c + (n == name) for n, c in before.items()}
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               atol=FLASH_TOL[name], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [63, 300, 2100])
@pytest.mark.parametrize("arch", sorted(ARCH_GROUPS))
def test_flash_backward_at_the_arch_groups(dev, arch, s, dtype):
    from repro_torch.kernels import flash_attention, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    h, kv, d, window = ARCH_GROUPS[arch]
    qs, k, v, do = _bwd_inputs(dev, 1, s, h, kv, d, dtype, s + h)
    o, lse = flash_attention.flash_attention_fwd(qs, k, v, window=window,
                                                 with_lse=True)
    name = "bfloat16" if dtype == torch.bfloat16 else "float32"
    before = dict(flash_attention.LAUNCHES_BWD_BY_DTYPE)
    got = flash_attention.flash_attention_bwd(qs, k, v, o, do, lse,
                                              window=window)
    want = ref.flash_attention_bwd_ref(qs, k, v, o, do, lse, window=window)
    torch.cuda.synchronize()
    assert flash_attention.LAUNCHES_BWD_BY_DTYPE == {
        n: c + (n == name) for n, c in before.items()}
    _bwd_close(got, want, dtype)


# --------------------------------------------------------------------------
# each kernel's op under DTensor on a one-rank NCCL mesh: its sharding
# strategy runs the same launch on the (whole) shard, bit for bit
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def one_rank_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    import socket

    import torch.distributed as dist

    from repro_torch.launch.mesh import make_mesh
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()


def _laid(t, mesh, dim):
    """``t`` as a DTensor over the one-rank mesh: replicated (dim None),
    or dim ``dim`` sharded over both axes."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    p = Replicate() if dim is None else Shard(dim)
    return DTensor.from_local(t, mesh, [p, p], run_check=False)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dim", [None, 0, 2], ids=["rep", "batch", "heads"])
def test_flash_ops_under_dtensor_equal_their_launch(one_rank_mesh, dtype,
                                                    dim):
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    b, s, h, kv, d = 2, 200, 4, 2, 64

    def rand(*shape):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    qs, k, v, do = rand(b, s, h, d), rand(b, s, kv, d), rand(b, s, kv, d), \
        rand(b, s, h, d)
    kw = dict(window=64, softcap=30.0)
    out, lse = fa.flash_attention_fwd(qs, k, v, with_lse=True, **kw)
    grads = fa.flash_attention_bwd(qs, k, v, out, do, lse, **kw)
    lay = [_laid(t, one_rank_mesh, dim) for t in (qs, k, v, do)]
    n_fwd, n_bwd = fa.LAUNCHES, fa.LAUNCHES_BWD
    d_out = fa.flash_attention_fwd(*lay[:3], **kw)
    d_out2, d_lse = fa.flash_attention_fwd(*lay[:3], with_lse=True, **kw)
    d_lse_in = _laid(lse, one_rank_mesh, None if dim is None
                     else {0: 0, 2: 1}[dim])
    d_grads = fa.flash_attention_bwd(*lay[:3], _laid(out, one_rank_mesh,
                                                     dim), lay[3],
                                     d_lse_in, **kw)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES, fa.LAUNCHES_BWD) == (n_fwd + 2, n_bwd + 1)
    assert torch.equal(d_out.full_tensor(), out)
    assert torch.equal(d_out2.full_tensor(), out)
    assert torch.equal(d_lse.full_tensor(), lse)
    for got, want in zip(d_grads, grads):
        assert torch.equal(got.full_tensor(), want)


@pytest.mark.parametrize("dim", [None, 0, 1], ids=["rep", "cases", "attrs"])
def test_histogram_op_under_dtensor_equals_its_launch(one_rank_mesh, dim):
    from repro_torch.kernels import histogram
    rng = np.random.default_rng(5)
    n, a, b, c, k = 5_000, 9, 64, 2, 32
    x = torch.as_tensor(rng.integers(-1, b, (n, a)).astype(np.int32),
                        device="cuda")
    y, slot = (torch.as_tensor(rng.integers(lo, hi, n).astype(np.int32),
                               device="cuda") for lo, hi in ((0, c), (-1, k)))
    w = torch.as_tensor(rng.integers(0, 4, n).astype(np.float32),
                        device="cuda")
    kw = dict(n_slots=k, n_bins=b, n_classes=c)
    want = histogram.frontier_histogram(x, y, w, slot, **kw)
    other = None if dim == 1 else dim
    before = histogram.LAUNCHES
    got = histogram.frontier_histogram(
        _laid(x, one_rank_mesh, dim),
        *(_laid(t, one_rank_mesh, other) for t in (y, w, slot)), **kw)
    torch.cuda.synchronize()
    assert histogram.LAUNCHES == before + 1
    assert torch.equal(got.full_tensor(), want)


@pytest.mark.parametrize("dim", [None, 0, 1], ids=["rep", "slots", "attrs"])
def test_split_gain_op_under_dtensor_equals_its_launch(one_rank_mesh, dim):
    from repro_torch.kernels import split_gain
    rng = np.random.default_rng(6)
    k, a, b, c = 16, 6, 32, 3
    hist = torch.as_tensor(rng.integers(0, 5, (k, a, b, c)).astype(
        np.float32), device="cuda")
    total = hist.sum((1, 2, 3)) / a
    cont = torch.as_tensor(rng.random(a) < 0.5, device="cuda")
    nb = torch.full((a,), b, dtype=torch.int32, device="cuda")
    want = split_gain.split_gain(hist, total, cont, nb)
    before = split_gain.LAUNCHES
    got = split_gain.split_gain(
        _laid(hist, one_rank_mesh, dim),
        _laid(total, one_rank_mesh, 0 if dim == 0 else None),
        *(_laid(t, one_rank_mesh, 0 if dim == 1 else None)
          for t in (cont, nb)))
    torch.cuda.synchronize()
    assert split_gain.LAUNCHES == before + 1
    for g_, w_ in zip(got, want):
        assert torch.equal(g_.full_tensor(), w_)


@pytest.mark.parametrize("dim", [None, 0, 1], ids=["rep", "trees", "cases"])
def test_forest_predict_op_under_dtensor_equals_its_launch(one_rank_mesh,
                                                           dim):
    from _forest_tables import random_cases, random_forest_table
    from repro_torch.kernels import tree_infer
    rng = np.random.default_rng(7)
    cont_np = rng.random(5) < 0.5
    tab_np, levels = random_forest_table(rng, 4, 63, cont_np)
    tab, x, cont = (torch.as_tensor(t, device="cuda") for t in
                    (tab_np, random_cases(rng, 900, cont_np), cont_np))
    want = tree_infer.forest_predict(tab, x, cont, max_depth=levels)
    before = tree_infer.LAUNCHES
    got = tree_infer.forest_predict(
        _laid(tab, one_rank_mesh, 0 if dim == 0 else None),
        _laid(x, one_rank_mesh, 0 if dim == 1 else None),
        _laid(cont, one_rank_mesh, None), max_depth=levels)
    torch.cuda.synchronize()
    assert tree_infer.LAUNCHES == before + 1
    assert torch.equal(got.full_tensor(), want)


@pytest.mark.parametrize("compact", [True, False])
def test_frontier_supersteps_on_a_one_rank_mesh_equal_unpartitioned(
        one_rank_mesh, compact):
    """Four supersteps with the cases as DTensors (the compaction on each
    rank's shard, the histogram and split-gain ops under their
    strategies, the splitPost kernels on each rank's local tensors) equal
    the unpartitioned ones bit for bit, with as many kernel launches."""
    import _torch_mesh
    from repro_torch.kernels import histogram, split_gain, split_post
    npz = _torch_mesh.tree_npz(compact)

    def run(mesh):
        before = histogram.LAUNCHES, split_gain.LAUNCHES, split_post.LAUNCHES
        out = _torch_mesh.superstep_out(
            *_torch_mesh.tree_cell(npz, "cuda"), mesh, 4, impl="cuda")
        torch.cuda.synchronize()
        return out, (histogram.LAUNCHES - before[0],
                     split_gain.LAUNCHES - before[1],
                     split_post.LAUNCHES - before[2])
    want, n_want = run(None)
    got, n_got = run(one_rank_mesh)
    assert n_got == n_want and n_want[0] > 0 and n_want[2] == 2 * 4
    assert int(got["n_nodes"]) > 1
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
