"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels have no CPU mode); without
one each test skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Histogram: exact for integral weights, atol 1e-4 / rtol 1e-5 for random f32
weights (device atomics add in no fixed order), in every regime of its plan
and with each plan pinned.  Split gain: bins and the
-inf pattern exact, scores within 1e-5 * (1 + |score|) (the discrete branch
sums its bins in another order than torch.sum).  Forest traversal: labels
exact.  Flash attention (bf16: the tensor-core kernel, f32: the scalar one):
f32 atol 3e-5, bf16 atol 2e-2 (another summation order, P rounded to bf16
before P . V; one bf16 rounding step of outputs near 1).  Its log-sum-exp
atol 1e-4, the output unchanged bit for bit when it is written.  The
backward kernel: f32 atol 2e-4, bf16 within 1% of the largest plain
gradient, and repeatable bit for bit.
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


def test_traced_build_equals_untraced_on_the_card(dev):
    """frontier.build(impl="cuda") with an enabled tracer (each phase a
    span that waits for the card) grows the untraced tree, with a span of
    each phase and a histogram and split-gain launch each superstep."""
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.tree import trees_equal
    from repro_torch.data import datasets
    from repro_torch.kernels import histogram, split_gain
    from repro_torch.obs import Registry, Tracer
    ds = datasets.load("census_pums", scale=0.01, max_bins=64)
    cfg = GrowConfig(max_nodes=1 << 14, frontier_slots=64)
    plain = frontier.build(ds, cfg, impl="cuda")
    tr, reg = Tracer(), Registry()
    h0, g0 = histogram.LAUNCHES, split_gain.LAUNCHES
    traced, rows = frontier.build(ds, cfg, impl="cuda", collect_stats=True,
                                  tracer=tr, metrics=reg)
    assert trees_equal(plain, traced)
    summ = tr.span_summary()
    for span in ("superstep", "splitPre", "splitAtt", "splitPost"):
        assert summ[span]["count"] == len(rows)
    assert split_gain.LAUNCHES - g0 == len(rows)
    assert histogram.LAUNCHES - h0 == sum(r["n_active"] > 0 for r in rows)
    phase = reg.snapshot()["frontier_phase_seconds"]["series"]
    assert len(phase) == 3 and all(s["count"] == len(rows) for s in phase)


def test_concurrent_builds_from_threads(dev):
    """4 frontier.build(impl="cuda") at once from threads, as the farm's
    workers launch them: three classes and B = 320 .. 1,024 bins put split
    gain on its shared-memory kernel with an opt-in of 34-101 KB that
    differs between the threads.  Each tree equals its build alone, and
    the launch counts are the lone builds' sum exactly."""
    import threading

    from repro_torch.core import binning, frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.tree import trees_equal
    from repro_torch.kernels import autotune, histogram, split_gain
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
    alone, counts = [], []
    for ds in sets:
        h0, g0 = histogram.LAUNCHES, split_gain.LAUNCHES
        alone.append(frontier.build(ds, cfg, impl="cuda"))
        counts.append((histogram.LAUNCHES - h0, split_gain.LAUNCHES - g0))
    got, errors = [None] * len(sets), []
    start = threading.Barrier(len(sets))

    def grow(i):
        try:
            start.wait()
            got[i] = frontier.build(sets[i], cfg, impl="cuda")
        except BaseException as e:       # surfaced below
            errors.append(e)
    h0, g0 = histogram.LAUNCHES, split_gain.LAUNCHES
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
    assert (histogram.LAUNCHES - h0, split_gain.LAUNCHES - g0) == tuple(
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


# The backward kernel (csrc/flash_attention_bwd.cu) against the plain
# backward on the same inputs: f32 atol 2e-4 (another summation order;
# chip_smoke.py measured at most 3.9e-5 on an H100); bf16 within 1% of the
# largest plain gradient (both round their f32 sums to bf16, a relative
# step of 2^-8; chip_smoke.py measured at most 0.0625 absolute).
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
