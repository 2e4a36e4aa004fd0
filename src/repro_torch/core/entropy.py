"""C4.5 entropy / information-gain math on torch tensors.

The torch counterpart of the JAX package's scorer, kept op for op in the
same order: this module is the specification the CUDA split-gain kernel
(``kernels/csrc/split_gain.cu``) is written against, and the plain path
that runs it on the CPU.  The formulas (paper Sect. 3.1, footnote 3):

    info(S)   = - sum_j  freq(c_j, S)/|S| * log2(freq(c_j, S)/|S|)
    gain(T, T_1..T_h) = info(T) - sum_i |T_i|/|T| * info(T_i)

with C4.5's unknown-value correction: frequencies are weighted counts over
cases with a known value for the tested attribute, and the gain is scaled by
the known fraction ``F = W_known / W_total``.

All functions are float32 and batched: leading dimensions are arbitrary.
Sums over the class axis add in ascending class order (the kernel's
order); sums over bins use ``torch.sum``.
"""

from __future__ import annotations

import torch

# A weighted count below EPS_W is treated as an empty partition.
EPS_W = 1e-7
# Gains below EPS_GAIN are treated as "no information".
EPS_GAIN = 1e-6

NEG_INF = float("-inf")


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).to(torch.float32)


def _sum_ascending(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along ``dim`` adding in ascending index order.

    Used for the class axis (and the 2-vector of a binary split), where the
    CUDA kernel adds in the same order; ``torch.sum`` on the card reduces in
    an order of its own, which rounds differently for three or more terms.
    """
    parts = torch.unbind(t, dim)
    if not parts:
        return torch.sum(t, dim=dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _xlogx(p: torch.Tensor) -> torch.Tensor:
    """x * log2(x), continuously extended with 0 at x == 0."""
    safe = torch.where(p > 0, p, 1.0)
    return torch.where(p > 0, p * torch.log2(safe), 0.0)


def info(counts: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Entropy (bits) of a weighted class-count vector; empty -> 0."""
    counts = _f32(counts)
    w = torch.sum(counts, dim=dim)
    safe_w = torch.where(w > EPS_W, w, 1.0)
    s = torch.sum(_xlogx(counts), dim=dim)
    ent = torch.log2(safe_w) - s / safe_w
    return torch.where(w > EPS_W, torch.clamp_min(ent, 0.0), 0.0)


def weighted_info(counts: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``W * info`` — the un-normalised term ``W*log2(W) - sum n log n``."""
    counts = _f32(counts)
    w = _sum_ascending(counts, dim)
    return torch.clamp_min(_xlogx(w) - _sum_ascending(_xlogx(counts), dim),
                           0.0)


def split_gain_from_children(child_counts: torch.Tensor, *,
                             total_w: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Information gain of a partition ``(..., H, C)`` -> ``(...)``.

    ``total_w`` (the node weight including unknown-valued cases) scales the
    gain by the known fraction; None means F = 1.
    """
    child_counts = _f32(child_counts)
    parent = torch.sum(child_counts, dim=-2)
    w_known = _sum_ascending(parent)
    safe_w = torch.where(w_known > EPS_W, w_known, 1.0)
    info_parent = weighted_info(parent)
    info_children = torch.sum(weighted_info(child_counts), dim=-1)
    gain = (info_parent - info_children) / safe_w
    if total_w is not None:
        total_w = _f32(total_w).to(gain.device)
        f = w_known / torch.where(total_w > EPS_W, total_w, 1.0)
        gain = f * gain
    return torch.where(w_known > EPS_W, torch.clamp_min(gain, 0.0), 0.0)


def split_info(child_counts: torch.Tensor) -> torch.Tensor:
    """C4.5 split-info (denominator of the gain ratio) over child weights."""
    w_children = _sum_ascending(_f32(child_counts))
    return info(w_children, dim=-1)


def fayyad_irani_mask(hist: torch.Tensor) -> torch.Tensor:
    """Boundary-point candidate mask: (..., B, C) -> bool (..., B).

    A cut after bin ``b`` is skipped (False) when the nearest non-empty bin
    on each side is pure and both carry the same class (Fayyad & Irani
    1992, Theorem 1).
    """
    hist = _f32(hist)
    b_dim = hist.shape[-2]
    nonzero = torch.sum(hist, -1) > EPS_W
    pure = torch.sum((hist > EPS_W).to(torch.int32), -1) == 1
    cls = torch.argmax(hist, -1)
    idx = torch.arange(b_dim, device=hist.device)

    # nearest non-empty bin at-or-before b / strictly-after b
    last = torch.cummax(torch.where(nonzero, idx, -1), dim=-1).values
    nxt_rev = torch.cummax(
        torch.where(torch.flip(nonzero, [-1]), idx, -1), dim=-1).values
    at_or_after = (b_dim - 1) - torch.flip(nxt_rev, [-1])
    nxt = torch.cat(
        [at_or_after[..., 1:],
         torch.full(at_or_after.shape[:-1] + (1,), b_dim,
                    dtype=at_or_after.dtype, device=hist.device)], dim=-1)

    def take(a, i):
        safe = torch.clamp(i, 0, b_dim - 1)
        return (torch.take_along_dim(a, safe, dim=-1),
                (i >= 0) & (i <= b_dim - 1))

    l_pure, l_ok = take(pure, last)
    l_cls, _ = take(cls, last)
    r_pure, r_ok = take(pure, nxt)
    r_cls, _ = take(cls, nxt)
    non_boundary = l_ok & r_ok & l_pure & r_pure & (l_cls == r_cls)
    return ~non_boundary


def _structural(n_bins, b_dim: int, offset: int, device) -> torch.Tensor:
    bins = torch.arange(b_dim, dtype=torch.int32, device=device)
    n_bins = torch.as_tensor(n_bins, dtype=torch.int32).to(device)
    if n_bins.ndim:
        return bins < (n_bins - offset)[..., None]
    return bins < n_bins - offset


def gains_for_continuous(hist: torch.Tensor, *, total_w: torch.Tensor,
                         n_bins, min_objs: float = 2.0,
                         criterion: str = "gain",
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Best binary split ``bin <= best_bin`` of a continuous attribute.

    ``hist`` is ``(..., B, C)``; every threshold ``b < n_bins-1`` whose two
    sides both weigh at least ``min_objs`` is a candidate.  Returns
    ``best_score (...)`` (-inf when no candidate) and ``best_bin (...)``
    int32, the first maximum.
    """
    hist = _f32(hist)
    left = torch.cumsum(hist, dim=-2)
    known = left[..., -1, :]
    right = known[..., None, :] - left

    w_known = _sum_ascending(known)
    safe_w = torch.where(w_known > EPS_W, w_known, 1.0)
    wl = _sum_ascending(left)
    wr = _sum_ascending(right)

    info_parent = weighted_info(known)
    info_lr = weighted_info(left) + weighted_info(right)
    gain = (info_parent[..., None] - info_lr) / safe_w[..., None]
    total_w = _f32(total_w).to(hist.device)
    f = w_known / torch.where(total_w > EPS_W, total_w, 1.0)
    gain = f[..., None] * gain

    if criterion == "gain_ratio":
        denom = info(torch.stack([wl, wr], dim=-1), dim=-1)  # 2 terms
        gain = torch.where(denom > EPS_W, gain / denom, 0.0)
    elif criterion != "gain":
        raise ValueError(f"unknown criterion: {criterion!r}")

    structural = _structural(n_bins, hist.shape[-2], 1, hist.device)
    valid = structural & (wl >= min_objs) & (wr >= min_objs)
    score = torch.where(valid, gain, NEG_INF)
    best_bin = torch.argmax(score, dim=-1).to(torch.int32)   # first max
    best_score = torch.amax(score, dim=-1)
    return best_score, best_bin


def gains_for_discrete(hist: torch.Tensor, *, total_w: torch.Tensor,
                       n_bins, min_objs: float = 2.0,
                       criterion: str = "gain") -> torch.Tensor:
    """Score of the h-way split of a discrete attribute (one child per
    value); -inf unless at least two branches weigh ``min_objs``."""
    hist = _f32(hist)
    structural = _structural(n_bins, hist.shape[-2], 0, hist.device)
    hist = torch.where(structural[..., None], hist, 0.0)

    gain = split_gain_from_children(hist, total_w=total_w)
    if criterion == "gain_ratio":
        denom = split_info(hist)
        gain = torch.where(denom > EPS_W, gain / denom, 0.0)

    w_children = _sum_ascending(hist)
    branches = torch.sum((w_children >= min_objs).to(torch.int32), dim=-1)
    return torch.where(branches >= 2, gain, NEG_INF)


def gains_from_histogram(hist: torch.Tensor, *, total_w: torch.Tensor,
                         attr_is_cont, n_bins, min_objs: float = 2.0,
                         criterion: str = "gain",
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-attribute best split from a ``(..., A, B, C)`` histogram.

    ``total_w`` broadcasts over the attribute axis; ``attr_is_cont`` and
    ``n_bins`` are ``(A,)``.  Returns ``(score, split_bin)`` of shape
    ``(..., A)``; ``split_bin`` is -1 for discrete attributes.
    """
    hist = _f32(hist)
    tw = _f32(total_w).to(hist.device)[..., None]
    cont_score, cont_bin = gains_for_continuous(
        hist, total_w=tw, n_bins=n_bins, min_objs=min_objs,
        criterion=criterion)
    disc_score = gains_for_discrete(
        hist, total_w=tw, n_bins=n_bins, min_objs=min_objs,
        criterion=criterion)
    attr_is_cont = torch.as_tensor(attr_is_cont, dtype=torch.bool).to(
        hist.device)
    score = torch.where(attr_is_cont, cont_score, disc_score)
    split_bin = torch.where(attr_is_cont, cont_bin, -1).to(torch.int32)
    return score, split_bin


def pick_best_attribute(score: torch.Tensor, active: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """First attribute with the maximal score among the active ones.

    Returns ``(best_attr, best_score, has_split)``; ``has_split`` requires a
    score above ``EPS_GAIN`` (no-gain nodes become leaves).
    """
    masked = torch.where(active, score, NEG_INF)
    best_attr = torch.argmax(masked, dim=-1).to(torch.int32)
    best_score = torch.amax(masked, dim=-1)
    return best_attr, best_score, best_score > EPS_GAIN
