"""Plain PyTorch versions of the CUDA kernels: what runs on the CPU, and
what the kernels are held against on the card."""

from __future__ import annotations

import torch

from repro_torch.core import entropy
from repro_torch.kernels.tree_infer import (
    COL_ATTR, COL_CHILD0, COL_CLASS, COL_HEAVY, COL_NCHILD, COL_SPLIT)


def frontier_histogram_ref(x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                           slot: torch.Tensor, *, n_slots: int, n_bins: int,
                           n_classes: int) -> torch.Tensor:
    """(K, A, B+1, C) weighted counts via one flat ``index_add_``.

    Bin B collects unknown values (-1); slot -1 goes to a dump row that is
    cut off.
    """
    n, a_dim = x.shape
    k, b, c = n_slots, n_bins, n_classes
    slot_safe = torch.where(slot >= 0, slot, k).long()
    bin_safe = torch.where(x >= 0, x, b).long()
    attr = torch.arange(a_dim, device=x.device)
    flat = ((slot_safe[:, None] * a_dim + attr[None, :]) * (b + 1)
            + bin_safe) * c + y.long()[:, None]
    hist = torch.zeros(((k + 1) * a_dim * (b + 1) * c,), dtype=torch.float32,
                       device=x.device)
    hist.index_add_(0, flat.reshape(-1),
                    w.to(torch.float32)[:, None].expand(n, a_dim).reshape(-1))
    return hist.reshape(k + 1, a_dim, b + 1, c)[:k]


def split_gain_ref(hist: torch.Tensor, total_w: torch.Tensor, attr_is_cont,
                   n_bins, *, min_objs: float = 2.0, criterion: str = "gain"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(score, split_bin) of shape (K, A) via the shared scorer."""
    return entropy.gains_from_histogram(
        hist, total_w=total_w, attr_is_cont=attr_is_cont, n_bins=n_bins,
        min_objs=min_objs, criterion=criterion)


def forest_predict_ref(node_tab: torch.Tensor, x_bins: torch.Tensor,
                       attr_is_cont: torch.Tensor, *, max_depth: int
                       ) -> torch.Tensor:
    """(T, N) int32 leaf classes: ``max_depth`` steps of
    :func:`repro_torch.core.tree.descend_once` over all T trees at once,
    gathering the (T, M) table columns at a (T, N) node tensor."""
    t_dim = node_tab.shape[0]
    n, a_dim = x_bins.shape
    col = node_tab.unbind(-1)
    node = torch.zeros((t_dim, n), dtype=torch.int64, device=x_bins.device)
    row0 = torch.arange(n, device=x_bins.device)[None, :] * a_dim
    x_flat = x_bins.reshape(-1)
    for _ in range(max_depth):
        attr = col[COL_ATTR].gather(1, node)
        nchild = col[COL_NCHILD].gather(1, node)
        a_safe = torch.clamp_min(attr, 0).long()
        b = x_flat[row0 + a_safe]
        child_cont = torch.where(b <= col[COL_SPLIT].gather(1, node), 0, 1)
        child = torch.where(attr_is_cont[a_safe], child_cont, b)
        # Unknown value: follow the heaviest child, as the build routed it.
        child = torch.where(b < 0, col[COL_HEAVY].gather(1, node), child)
        child = torch.minimum(torch.clamp_min(child, 0),
                              torch.clamp_min(nchild - 1, 0))
        nxt = col[COL_CHILD0].gather(1, node) + child
        node = torch.where(nchild == 0, node, nxt.long())
    return col[COL_CLASS].gather(1, node)
