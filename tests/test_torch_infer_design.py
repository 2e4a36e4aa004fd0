"""The design of the CUDA forest-traversal kernel, held on the CPU.

The kernel runs only on the card; what surrounds it is Python that runs
here: its launch plan (``autotune.plan_infer_blocks``) and a torch
emulation of its decomposition, step for step as ``csrc/tree_infer.cu``
takes it: a (case blocks, trees) grid whose y extent stops at GRID_Y_MAX
trees, a thread a case, walking its block's trees 65,535 apart; a walk
stopped at a leaf or at max_depth, the class read at the node where it
stops.

Held exactly (labels are integers) against the port's plain version
``ref.forest_predict_ref``, against the JAX package's Pallas kernel in
interpret mode on tables within its contract, and against the JAX
``descend_once`` on tables with an attribute of -1 or at or above A at an
internal node (where the Pallas kernel's one-hot reads differ: it reads
both as bin 0 of a discrete attribute).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _forest_tables import random_cases, random_forest_table, \
    shuffle_node_ids
from repro.core import tree as jtree
from repro.kernels import tree_infer as jinfer
from repro_torch.kernels import autotune, ref

SMS = autotune.H100_SMS


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------

def test_plan_full_shape_is_wide():
    """T = 16, N = 10M: 1,024 cases a block, 9,766 blocks a tree."""
    p = autotune.plan_infer_blocks(n_cases=10_000_000, n_trees=16)
    assert (p.mode, p.threads) == ("wide", 1024)
    assert (p.case_blocks, p.tree_blocks) == (9766, 16)


def test_plan_serving_batch_fills_the_card():
    """T = 16, N = 1,024: the 16K walks on at least one block an SM."""
    p = autotune.plan_infer_blocks(n_cases=1024, n_trees=16)
    assert p.mode == "spread" and p.blocks >= SMS


@pytest.mark.parametrize("n", [1, 257, 1024, 5_000, 299_285])
@pytest.mark.parametrize("t", [1, 4, 16])
def test_plan_spreads_small_launches(n, t):
    """Every SM gets a block where the walks allow it, and a block is never
    wider than the cases (in whole warps) or narrower than it needs to
    be."""
    p = autotune.plan_infer_blocks(n_cases=n, n_trees=t)
    assert p.blocks >= min(SMS, t * -(-n // 32))
    assert p.threads <= max(32, 32 * -(-n // 32))
    if p.threads < 1024 and 2 * p.threads <= 32 * -(-n // 32):
        assert t * -(-n // (2 * p.threads)) < SMS


def test_plan_many_trees_plans_a_grid():
    """T = 70,000 (past the 65,535 of a grid's y extent): the grid stops
    there and its blocks walk the trees beyond in turn; a grid past 2^31 - 1
    blocks a tree is refused."""
    p = autotune.plan_infer_blocks(n_cases=1024, n_trees=70_000)
    assert (p.threads, p.case_blocks, p.tree_blocks) == (1024, 1, 65_535)
    p = autotune.plan_infer_blocks(n_cases=65, n_trees=70_000)
    assert p.tree_blocks == autotune.GRID_Y_MAX
    with pytest.raises(ValueError, match="2\\^31"):
        autotune.plan_infer_blocks(n_cases=1 << 37, n_trees=1, block_n=32)


@pytest.mark.parametrize("seed", range(4))
def test_plan_never_exceeds_block_limits(seed):
    rng = np.random.default_rng(seed)
    for _ in range(300):
        n = int(rng.integers(1, 20_000_000))
        t = int(rng.choice([1, 3, 16, 100, 70_000]))
        p = autotune.plan_infer_blocks(n_cases=n, n_trees=t)
        assert p.threads in (32, 64, 128, 256, 512, 1024)
        assert p.case_blocks * p.threads >= n > (p.case_blocks - 1) \
            * p.threads
        assert p.case_blocks < 2 ** 31
        assert p.tree_blocks == min(t, autotune.GRID_Y_MAX)
        assert p.mode == ("wide" if p.threads == 1024 else "spread")


def test_plan_pins_are_honoured_or_refused():
    for block_n in (32, 96, 1024):
        p = autotune.plan_infer_blocks(n_cases=5000, n_trees=6,
                                       block_n=block_n)
        assert p.threads == block_n and p.case_blocks == -(-5000 // block_n)
    for bad in (0, 16, 48, 1056, 2048):
        with pytest.raises(ValueError, match="multiple of 32"):
            autotune.plan_infer_blocks(n_cases=5000, n_trees=6,
                                       block_n=bad)


# --------------------------------------------------------------------------
# the kernel's decomposition, emulated
# --------------------------------------------------------------------------

UNWRITTEN = -(2 ** 30)


def emulate_forest_predict(tab, x, cont, *, max_depth, plan):
    """``csrc/tree_infer.cu`` for every (block, thread) of the plan's grid
    at once: thread i of block (bx, by) walks case bx * threads + i through
    trees by, by + tree_blocks, ...; a walk runs until it stops (a leaf or
    max_depth), then writes its class once."""
    t_dim, m_dim, _ = tab.shape
    n, a_dim = x.shape
    lo, hi = tab[..., :4].long(), tab[..., 4:].long()
    i = (torch.arange(plan.case_blocks)[:, None] * plan.threads
         + torch.arange(plan.threads)[None, :]).reshape(-1)
    i = i[i < n]                                  # threads past N return
    t = torch.cat([torch.arange(by, t_dim, plan.tree_blocks)
                   for by in range(plan.tree_blocks)])
    t, i = t.repeat_interleave(len(i)), i.repeat(len(t))
    xs = x.long()[i]                              # each thread's row
    node = torch.zeros_like(i)
    walking = torch.ones_like(i, dtype=torch.bool)
    for _ in range(max_depth):
        row = lo[t, node]
        walking &= row[:, 3] != 0                 # a leaf: break
        a = row[:, 0].clamp_min(0)
        inside = a < a_dim
        a_safe = a.clamp(max=a_dim - 1)
        b = torch.where(inside, xs.gather(1, a_safe[:, None])[:, 0], -1)
        child = torch.where(
            b < 0, hi[t, node, 0],
            torch.where(cont.bool()[a_safe], torch.where(b <= row[:, 1], 0, 1),
                        b))
        child = torch.minimum(child.clamp_min(0), row[:, 3] - 1)
        node = torch.where(walking, row[:, 2] + child, node)
    out = torch.full((t_dim, n), UNWRITTEN, dtype=torch.int64)
    writes = torch.zeros((t_dim, n), dtype=torch.int64)
    out[t, i] = hi[t, node, 1]
    writes.index_put_((t, i), torch.ones_like(i), accumulate=True)
    assert bool((writes == 1).all()), "a label written twice or never"
    return out.to(torch.int32)


def jax_pallas(tab, x, cont, max_depth):
    return np.asarray(jinfer.forest_predict(
        jnp.asarray(tab), jnp.asarray(x), jnp.asarray(cont),
        max_depth=max_depth, interpret=True))


def jax_descend(tab, x, cont, max_depth):
    """The JAX package's ``descend_once``, max_depth times a tree."""
    labels = []
    for t in range(tab.shape[0]):
        cols = {k: jnp.asarray(tab[t, :, i]) for i, k in enumerate(
            ("node_attr", "node_split_bin", "node_child0", "node_nchild",
             "heavy"))}
        node = jnp.zeros(x.shape[0], jnp.int32)
        for _ in range(max_depth):
            node = jtree.descend_once(jnp.asarray(cont), node,
                                      jnp.asarray(x), **cols)
        labels.append(tab[t, :, 5][np.asarray(node)])
    return np.stack(labels)


def _forest(seed, t, m, a, n, *, shuffle=False, unknown=0.15,
            max_children=6, leaf_p=0.15):
    rng = np.random.default_rng(seed)
    cont = rng.random(a) < 0.5
    tab, levels = random_forest_table(rng, t, m, cont, n_bins=8,
                                      max_children=max_children,
                                      leaf_p=leaf_p)
    if shuffle:
        tab = shuffle_node_ids(rng, tab)
    return tab, random_cases(rng, n, cont, unknown=unknown), cont, levels


def _check(tab, x, cont, depth, plan, want):
    got = emulate_forest_predict(torch.as_tensor(tab), torch.as_tensor(x),
                                 torch.as_tensor(cont), max_depth=depth,
                                 plan=plan)
    plain = ref.forest_predict_ref(torch.as_tensor(tab), torch.as_tensor(x),
                                   torch.as_tensor(cont), max_depth=depth)
    assert torch.equal(got, plain)
    assert np.array_equal(got.numpy(), want)


# (T, M, A, N, shuffled ids, block_n): N off every block, the plan's own
# choice and pins, ids whose low rows are not the top levels, a lone leaf,
# wide discrete splits, A = 2,000
EMU_CASES = [
    (4, 64, 5, 257, False, None),
    (5, 200, 9, 300, False, 64),
    (3, 200, 9, 300, True, 32),
    (6, 120, 7, 1000, True, None),
    (2, 300, 40, 150, True, 128),
    (1, 1, 3, 33, False, None),
    (3, 60, 2000, 70, False, None),
]


@pytest.mark.parametrize("t,m,a,n,shuffle,block_n", EMU_CASES)
def test_emulation_matches_jax_pallas(t, m, a, n, shuffle, block_n):
    tab, x, cont, levels = _forest(t * m + a, t, m, a, n, shuffle=shuffle)
    plan = autotune.plan_infer_blocks(n_cases=n, n_trees=t, block_n=block_n)
    for depth in (levels, min(levels, 2), 0):
        _check(tab, x, cont, depth, plan, jax_pallas(tab, x, cont, depth))


def test_emulation_many_small_trees(monkeypatch):
    """Lone leaves and trees of depth 1 and 2, more trees than the grid's
    y extent (cut to 7 here), so that blocks walk several trees in turn."""
    monkeypatch.setattr(autotune, "GRID_Y_MAX", 7)
    tab, x, cont, levels = _forest(3, 300, 7, 4, 45, max_children=2,
                                   leaf_p=0.3)
    plan = autotune.plan_infer_blocks(n_cases=45, n_trees=300, block_n=32)
    assert (plan.case_blocks, plan.tree_blocks) == (2, 7)
    _check(tab, x, cont, levels, plan, jax_pallas(tab, x, cont, levels))


@pytest.mark.parametrize("shuffle", [False, True])
def test_emulation_out_of_contract_attributes_match_jax_descend(shuffle):
    """An attribute of -1 at an internal node reads column 0; one at or
    above A reads as unknown (the heavy child)."""
    tab, x, cont, levels = _forest(9, 4, 150, 6, 260, shuffle=shuffle,
                                   unknown=0.05)
    rng = np.random.default_rng(1)
    internal = np.argwhere(tab[..., 3] > 0)
    pick = internal[rng.random(len(internal)) < 0.4]
    tab[pick[:, 0], pick[:, 1], 0] = rng.choice([-1, 6, 7, 1000], len(pick))
    for block_n in (None, 96):
        plan = autotune.plan_infer_blocks(n_cases=260, n_trees=4,
                                          block_n=block_n)
        for depth in (levels, 3):
            _check(tab, x, cont, depth, plan,
                   jax_descend(tab, x, cont, depth))
