"""Plain PyTorch versions of the two CUDA kernels: what runs on the CPU, and
what the kernels are held against on the card."""

from __future__ import annotations

import torch

from repro_torch.core import entropy


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
