"""Random packed forest tables for the traversal-kernel tests (numpy only,
so the card's tests can use it without JAX)."""

import numpy as np

NODE_COLS = 8


def random_forest_table(rng, n_trees, capacity, attr_is_cont, *, n_bins=8,
                        n_classes=3, max_children=5, leaf_p=0.3):
    """``(T, M, 8)`` int32 table of random breadth-first trees, and the
    descent depth that reaches every leaf.

    Each tree fills a random live prefix of the capacity; rows past it are
    leaf-shaped padding (attr -1, nchild 0).  Continuous nodes have two
    children and a threshold bin; discrete nodes 2..``max_children``
    children, so bins at or above nchild exercise the clip.
    """
    cont = np.asarray(attr_is_cont, bool)
    tab = np.zeros((n_trees, capacity, NODE_COLS), np.int32)
    tab[..., 0] = -1
    tab[..., 1] = -1
    deepest = 0
    for t in range(n_trees):
        target = int(rng.integers(1, capacity + 1))
        depth, n_live, i = [0], 1, 0
        while i < n_live:
            a = int(rng.integers(len(cont)))
            nc = 2 if cont[a] else int(rng.integers(2, max_children + 1))
            if n_live + nc <= target and rng.random() > leaf_p:
                split = int(rng.integers(0, n_bins)) if cont[a] else -1
                tab[t, i, :6] = (a, split, n_live, nc, rng.integers(nc),
                                 rng.integers(n_classes))
                depth += [depth[i] + 1] * nc
                n_live += nc
            else:
                tab[t, i, 5] = rng.integers(n_classes)
            i += 1
        deepest = max(deepest, max(depth))
    return tab, deepest + 1


def random_cases(rng, n, attr_is_cont, *, n_bins=8, unknown=0.15):
    """(N, A) int32 bins in [0, n_bins) with a share of unknowns (-1)."""
    x = rng.integers(0, n_bins, (n, len(attr_is_cont))).astype(np.int32)
    x[rng.random(x.shape) < unknown] = -1
    return x


def shuffle_node_ids(rng, tab):
    """The same forest with its node ids permuted: the root stays at row 0
    and each node's children stay contiguous and in order, but the blocks
    of siblings (and the unreachable rows) take random places, so the
    lowest ids no longer hold the top levels."""
    out = np.empty_like(tab)
    n_trees, capacity, _ = tab.shape
    for t in range(n_trees):
        rows = tab[t]
        covered = np.zeros(capacity, bool)
        covered[0] = True
        blocks = []
        for i in np.flatnonzero(rows[:, 3] > 0):
            c0, nc = int(rows[i, 2]), int(rows[i, 3])
            blocks.append(np.arange(c0, c0 + nc))
            covered[c0:c0 + nc] = True
        blocks += [np.array([i]) for i in np.flatnonzero(~covered)]
        old = np.concatenate(
            [[0]] + [blocks[b] for b in rng.permutation(len(blocks))])
        new_id = np.empty(capacity, np.int64)
        new_id[old] = np.arange(capacity)
        out[t, new_id] = rows
        internal = rows[:, 3] > 0
        out[t, new_id[internal], 2] = new_id[rows[internal, 2]]
    return out
