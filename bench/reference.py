"""The plain reference: C4.5 growth, level by level, in plain torch.

It decides what the program's tree has to be, from the benchmark's own
inputs, and imports nothing of the program.  The semantics are those the
configuration states (its ``grow`` block), with unit case weights and no
unknown values:

  * a node is a leaf before any test when it is pure, weighs less than
    ``2 * min_objs`` or lies at ``max_depth``;
  * otherwise each active attribute is scored by C4.5's information gain
    (paper Sect. 3.1, footnote 3): ``gain = (wi(node) - sum wi(child)) /
    W`` with ``wi(n) = xlogx(sum_c n_c) - sum_c xlogx(n_c)``; a continuous
    attribute by its best binary split ``bin <= t`` over thresholds ``t <
    n_bins - 1`` whose two sides weigh at least ``min_objs`` (the lowest
    ``t`` on a tie), a discrete one by its split into one child per value,
    valid when two children weigh ``min_objs``; the first attribute with
    the best score splits when the score exceeds ``EPS_GAIN``, and a
    discrete attribute is not tested again below its split;
  * nodes are numbered breadth first: the open nodes are taken in id order,
    ``frontier_slots`` at a time, and a batch's children get the next ids
    in order; a batch whose children would pass ``max_nodes`` makes all of
    its nodes leaves;
  * a node's class frequencies are the counts of its cases' classes, its
    class the first most frequent one, or its parent's when it has no case.

Class counts are exact integers.  The scores are computed in ``dtype``:
float64 for the oracle, a lower precision for the control.  The float64
scores differ from the program's float32 ones by rounding, so where a
tested tree takes another split than the oracle's best, and that split
scores within :func:`tie_tolerance` of it (or within it of ``EPS_GAIN``),
the oracle takes the tested tree's split and counts a near tie.  Nothing
else of the tested tree is read.

``grow`` returns the tree as numpy arrays; :func:`compare` counts the nodes
of a tested tree that differ from it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

EPS_GAIN = 1e-6
# Two float64 scores closer than this are equal (the running sums behind a
# score round to about 1e-8 of a bit at the smallest nodes).
EPS_EQUAL = 1e-7
FIELDS = ("node_attr", "node_split_bin", "node_child0", "node_nchild",
          "node_class", "node_freq", "node_depth")


@dataclasses.dataclass
class Grow:
    """The growth parameters a configuration states."""
    max_nodes: int
    frontier_slots: int
    min_objs: float
    max_depth: int
    criterion: str = "gain"

    @staticmethod
    def of(grow: dict) -> "Grow":
        g = Grow(**{f.name: grow[f.name] for f in dataclasses.fields(Grow)
                    if f.name in grow})
        if g.criterion != "gain":
            raise ValueError("the reference scores by information gain only")
        return g


@dataclasses.dataclass
class Result:
    tree: dict[str, np.ndarray]     # FIELDS, each of n_nodes rows
    n_nodes: int
    overflow: bool                  # capacity made early leaves
    near_ties: int                  # splits taken from the tested tree
    # the farthest split taken from the tested tree, as a share of its
    # tolerance
    tie_share: float = 0.0
    # the work of scoring, counted over the scored nodes: their cases, the
    # non-zero cells of their (A, B, C) histograms, and the non-empty
    # (attribute, bin) pairs of those
    scored_nodes: int = 0
    scored_cases: int = 0
    nonzero_cells: int = 0
    nonzero_bins: int = 0


def tie_tolerance(w: np.ndarray, n_classes: int, max_children: int
                  ) -> np.ndarray:
    """How far a float32 score of a node of weight ``w`` may lie from the
    exact one: the score is ``U / W`` with ``U`` a sum of about ``8 + 4C +
    H`` terms ``n log2 n`` of at most ``W log2 W`` each, each rounded to
    float32 (2**-23 of its size at most)."""
    terms = 8 + 4 * n_classes + max_children
    return terms * 2.0 ** -23 * np.log2(np.maximum(w, 2.0))


def _xlogx(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v > 0, v * torch.log2(torch.where(v > 0, v, 1)), 0)


def _segment_start(keys: torch.Tensor) -> torch.Tensor:
    """Index of the first element of each element's run of equal keys."""
    n = keys.numel()
    new = torch.ones(n, dtype=torch.bool, device=keys.device)
    new[1:] = keys[1:] != keys[:-1]
    idx = torch.arange(n, device=keys.device)
    return torch.cummax(torch.where(new, idx, 0), 0).values


def _segment_cumsum(v: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Inclusive running sum of ``v`` within runs of equal ``keys``,
    rounded to ``v``'s dtype (the running sum itself is float64, so that
    its runs do not cancel each other)."""
    v64 = v.double()
    c = torch.cumsum(v64, 0)
    start = _segment_start(keys)
    return (c - (c[start] - v64[start])).to(v.dtype)


class _Scorer:
    """Scores of one batch of nodes, attribute by attribute."""

    def __init__(self, x, y, n_bins, is_cont, n_classes, min_objs, dtype):
        self.x, self.y = x, y
        self.n_bins, self.is_cont = n_bins, is_cont
        self.c = n_classes
        self.b = int(max(n_bins))
        self.min_objs = min_objs
        self.dtype = dtype
        # scores this close count as equal, so that the first wins as in
        # exact arithmetic (a float64 score's rounding is far below it)
        self.eps = EPS_EQUAL if dtype == torch.float64 else 0.0
        self.cases = self.cells = self.bins = 0

    def score(self, cases, local, n_local, freq, want_attr, want_bin):
        """(score, bin) of every (node, attribute), and the score of the
        tested tree's split ``(want_attr, want_bin)`` per node (-inf where
        it has none).  ``cases`` are the batch's case ids, ``local`` their
        node in the batch, ``freq`` the nodes' (n_local, C) class counts."""
        dev, dt = cases.device, self.dtype
        a_dim = self.x.shape[1]
        w = freq.sum(1)
        s_k = _xlogx(freq).sum(1)
        wi_node = torch.clamp_min(_xlogx(w) - s_k, 0)
        score = torch.full((n_local, a_dim), -torch.inf, dtype=dt,
                           device=dev)
        best_bin = torch.full((n_local, a_dim), -1, dtype=torch.int64,
                              device=dev)
        wanted = torch.full((n_local,), -torch.inf, dtype=dt, device=dev)
        y = self.y[cases]
        self.cases += int(cases.numel())
        for a in range(a_dim):
            key = (local * self.b + self.x[cases, a].long()) * self.c + y
            uk, cnt = torch.unique(key, return_counts=True)
            e_node = uk // (self.b * self.c)
            e_bin = (uk // self.c) % self.b
            e_cls = uk % self.c
            group = uk // self.c                        # (node, bin)
            g_start = _segment_start(group)
            g_first = torch.nonzero(g_start == torch.arange(
                uk.numel(), device=dev)).flatten()
            g_node, g_bin = e_node[g_first], e_bin[g_first]
            g_id = torch.cumsum((g_start == torch.arange(
                uk.numel(), device=dev)).long(), 0) - 1
            n_groups = g_first.numel()
            self.cells += int(uk.numel())
            self.bins += n_groups
            cnt_f = cnt.to(dt)

            def per_group(v):
                return torch.zeros(n_groups, dtype=dt,
                                   device=dev).index_add_(0, g_id, v)

            if self.is_cont[a]:
                # left counts of each class up to this bin: runs of
                # (node, class) ordered by bin
                order = torch.argsort(e_node * self.c + e_cls, stable=True)
                run = (e_node * self.c + e_cls)[order]
                left_c = torch.empty_like(cnt_f)
                left_c[order] = _segment_cumsum(cnt_f[order], run)
                prev_c = left_c - cnt_f
                k_c = freq[e_node, e_cls]
                d_left = _xlogx(left_c) - _xlogx(prev_c)
                d_right = _xlogx(k_c - left_c) - _xlogx(k_c - prev_c)
                s_left = _segment_cumsum(per_group(d_left), g_node)
                s_right = s_k[g_node] + _segment_cumsum(per_group(d_right),
                                                        g_node)
                w_left = _segment_cumsum(per_group(cnt_f), g_node)
                w_node = w[g_node]
                w_right = w_node - w_left
                wi_l = torch.clamp_min(_xlogx(w_left) - s_left, 0)
                wi_r = torch.clamp_min(_xlogx(w_right) - s_right, 0)
                gain = (wi_node[g_node] - (wi_l + wi_r)) / w_node
                valid = ((g_bin < self.n_bins[a] - 1)
                         & (w_left >= self.min_objs)
                         & (w_right >= self.min_objs))
                gain = torch.where(valid, gain, -torch.inf)
                top = torch.full((n_local,), -torch.inf, dtype=dt,
                                 device=dev).scatter_reduce(
                    0, g_node, gain, "amax")
                at_top = ((gain >= top[g_node] - self.eps)
                          & (gain > -torch.inf))
                low = torch.full((n_local,), self.b, dtype=torch.int64,
                                 device=dev).scatter_reduce(
                    0, g_node[at_top], g_bin[at_top], "amin")
                score[:, a] = top
                best_bin[:, a] = torch.where(top > -torch.inf, low, -1)
                hit = (want_attr[g_node] == a) & (want_bin[g_node] == g_bin)
                wanted[g_node[hit]] = gain[hit]
            else:
                w_g = per_group(cnt_f)
                wi_g = torch.clamp_min(_xlogx(w_g) - per_group(_xlogx(cnt_f)),
                                       0)
                child = torch.zeros(n_local, dtype=dt,
                                    device=dev).index_add_(0, g_node, wi_g)
                branches = torch.zeros(n_local, dtype=torch.int64,
                                       device=dev).index_add_(
                    0, g_node, (w_g >= self.min_objs).long())
                gain = (wi_node - child) / w
                score[:, a] = torch.where(branches >= 2, gain, -torch.inf)
                mine = want_attr == a
                wanted[mine] = score[mine, a]
        return score, best_bin, wanted


def grow(x: torch.Tensor, y: torch.Tensor, *, n_bins, attr_is_cont,
         n_classes: int, grow: Grow, dtype=torch.float64,
         tested: dict[str, np.ndarray] | None = None) -> Result:
    """The tree the configuration asks for, on ``x`` (int32 (N, A) bins)
    and ``y`` (int64 (N,) classes), on their device.  ``tested`` (a tree's
    ``FIELDS``, host arrays) only settles near ties."""
    dev = x.device
    n_cases, a_dim = x.shape
    c_dim = n_classes
    m, k = grow.max_nodes, grow.frontier_slots
    n_bins = np.asarray(n_bins, np.int64)
    is_cont = np.asarray(attr_is_cont, bool)
    h_dim = max([2, *n_bins[~is_cont].tolist()])
    scorer = _Scorer(x, y, n_bins.tolist(), is_cont.tolist(), c_dim,
                     grow.min_objs, dtype)
    if (x < 0).any():
        raise ValueError("the reference takes no unknown values")

    attr = np.full(m, -1, np.int64)
    split_bin = np.full(m, -1, np.int64)
    child0 = np.zeros(m, np.int64)
    nchild = np.zeros(m, np.int64)
    cls = np.zeros(m, np.int64)
    depth = np.zeros(m, np.int64)
    freq = np.zeros((m, c_dim), np.int64)
    active = np.ones((m, a_dim), bool)
    # the decision of each node: split (attr, bin) or leaf
    d_attr = np.full(m, -1, np.int64)
    d_bin = np.full(m, -1, np.int64)

    case_node = torch.zeros(n_cases, dtype=torch.int64, device=dev)
    freq[0] = torch.bincount(y, minlength=c_dim).cpu().numpy()
    cls[0] = int(np.argmax(freq[0]))
    if tested is not None:
        t_n = len(tested["node_attr"])
        t_attr = np.full(m, -1, np.int64)
        t_bin = np.full(m, -1, np.int64)
        t_attr[:t_n] = tested["node_attr"]
        t_bin[:t_n] = tested["node_split_bin"]
    n, pos, decided, n_scored = 1, 0, 0, 0
    overflow = False
    near_ties, tie_share = 0, 0.0
    while pos < n:
        # ---- decide every node that exists and is not decided yet
        lo, hi = decided, n
        f = freq[lo:hi]
        w = f.sum(1)
        pre_leaf = (((f > 0).sum(1) <= 1) | (w < 2 * grow.min_objs)
                    | (depth[lo:hi] >= grow.max_depth))
        scored = np.nonzero(~pre_leaf)[0]
        if scored.size:
            n_scored += int(scored.size)
            local_of = torch.full((m,), -1, dtype=torch.int64, device=dev)
            local_of[torch.as_tensor(lo + scored, device=dev)] = torch.arange(
                scored.size, device=dev)
            local = local_of[case_node]
            cases = torch.nonzero(local >= 0).flatten()
            ids = lo + scored
            want_attr = (t_attr[ids] if tested is not None
                         else np.full(ids.size, -1))
            want_bin = (t_bin[ids] if tested is not None
                        else np.full(ids.size, -1))
            score, best_bin, wanted = scorer.score(
                cases, local[cases], int(scored.size),
                torch.as_tensor(freq[ids], dtype=dtype, device=dev),
                torch.as_tensor(want_attr, device=dev),
                torch.as_tensor(want_bin, device=dev))
            act = torch.as_tensor(active[ids], device=dev)
            masked = torch.where(act, score, -torch.inf)
            best = masked.max(1).values
            best_attr = torch.argmax(
                ((masked >= best[:, None] - scorer.eps)
                 & (masked > -torch.inf)).to(torch.int8), 1)
            bbin = best_bin.gather(1, best_attr[:, None])[:, 0]
            best_attr = best_attr.cpu().numpy()
            best = best.double().cpu().numpy()
            bbin = bbin.cpu().numpy()
            split = best > EPS_GAIN
            if tested is not None:
                wanted = wanted.double().cpu().numpy()
                tol = tie_tolerance(w[scored].astype(np.float64), c_dim,
                                    h_dim)
                w_act = active[ids, np.clip(want_attr, 0, a_dim - 1)]
                t_split = want_attr >= 0
                other = t_split & ((want_attr != best_attr)
                                   | (want_bin != np.where(
                                       is_cont[best_attr], bbin, -1))
                                   | ~split)
                take = (other & w_act & (wanted >= best - tol)
                        & (wanted > EPS_GAIN - tol))
                # a tested leaf where the best split scores near EPS_GAIN
                leaf = (~t_split & split & (best <= EPS_GAIN + tol)
                        & (ids < len(tested["node_attr"])))
                near_ties += int(take.sum() + leaf.sum())
                # how far the splits taken lie below the best, or below
                # EPS_GAIN, as a share of the tolerance (a leaf taken is
                # left out: where its batch passes the capacity it is a
                # leaf whatever its score)
                dist = np.maximum(best - wanted, EPS_GAIN - wanted)[take]
                if dist.size:
                    tie_share = max(tie_share,
                                    float((dist / tol[take]).max()))
                best_attr = np.where(take, want_attr, best_attr)
                bbin = np.where(take, want_bin, bbin)
                split = (split | take) & ~leaf
            d_attr[ids] = np.where(split, best_attr, -1)
            d_bin[ids] = np.where(split & is_cont[best_attr], bbin, -1)
        decided = hi

        # ---- batches of open nodes in id order, as far as decided
        split_now = []
        while pos < n:
            end = min(pos + k, n)
            if end > decided:
                break
            ids = np.arange(pos, end)
            a = d_attr[ids]
            internal = a >= 0
            nch = np.where(internal, np.where(is_cont[np.maximum(a, 0)], 2,
                                              n_bins[np.maximum(a, 0)]), 0)
            if n + nch.sum() > m:
                overflow = True
                internal[:] = False
                nch[:] = 0
            c0 = n + np.cumsum(nch) - nch
            attr[ids] = np.where(internal, a, -1)
            split_bin[ids] = np.where(internal, d_bin[ids], -1)
            child0[ids] = np.where(internal, c0, 0)
            nchild[ids] = nch
            parent = np.repeat(ids[internal], nch[internal])
            kids = np.arange(n, n + parent.size)
            depth[kids] = depth[parent] + 1
            active[kids] = active[parent]
            used = ~is_cont[attr[parent]]
            active[kids[used], attr[parent[used]]] = False
            split_now.append(parent)
            n += parent.size
            pos = end

        # ---- route the cases of the nodes split, count their children
        if split_now:
            parent = np.concatenate(split_now)     # of nodes first..n-1
            split_ids = torch.as_tensor(np.unique(parent), device=dev)
            is_split = torch.zeros(m, dtype=torch.bool, device=dev)
            is_split[split_ids] = True
            attr_d = torch.as_tensor(attr, device=dev)
            bin_d = torch.as_tensor(split_bin, device=dev)
            child0_d = torch.as_tensor(child0, device=dev)
            moved = torch.nonzero(is_split[case_node]).flatten()
            nd = case_node[moved]
            a = attr_d[nd]
            v = x[moved, a].long()
            cont = torch.as_tensor(is_cont, device=dev)[a]
            j = torch.where(cont, (v > bin_d[nd]).long(), v)
            case_node[moved] = child0_d[nd] + j
            first = n - parent.size
            counts = torch.bincount(
                (case_node[moved] - first) * c_dim + y[moved],
                minlength=parent.size * c_dim).view(parent.size, c_dim)
            kf = counts.cpu().numpy()
            freq[first:n] = kf
            cls[first:n] = np.where(kf.sum(1) > 0, np.argmax(kf, 1),
                                    cls[parent])

    tree = dict(node_attr=attr[:n], node_split_bin=split_bin[:n],
                node_child0=child0[:n], node_nchild=nchild[:n],
                node_class=cls[:n], node_freq=freq[:n],
                node_depth=depth[:n])
    return Result(tree=tree, n_nodes=n, overflow=overflow,
                  near_ties=near_ties, tie_share=tie_share,
                  scored_nodes=n_scored,
                  scored_cases=scorer.cases, nonzero_cells=scorer.cells,
                  nonzero_bins=scorer.bins)


def compare(tested: dict[str, np.ndarray], ref: dict[str, np.ndarray]
            ) -> int:
    """Nodes at which the tested tree differs from the reference in any
    field, counting a node that only one of them has."""
    n_t, n_r = len(tested["node_attr"]), len(ref["node_attr"])
    n = min(n_t, n_r)
    bad = np.zeros(n, bool)
    for f in FIELDS:
        t, r = np.asarray(tested[f])[:n], np.asarray(ref[f])[:n]
        diff = t != r
        bad |= diff.any(axis=tuple(range(1, diff.ndim))) if diff.ndim > 1 \
            else diff
    return int(bad.sum()) + abs(n_t - n_r)
