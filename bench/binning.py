"""Rank-space binning of raw columns on the device, for the generators.

A torch rewrite, frozen for the benchmark, of ``fit``'s binning in
``src/repro_torch/core/binning.py`` at commit
fe76ba3c169015bc8474eaf345bd872003045a00:

  * a continuous column with at most ``max_bins`` distinct values: bin b is
    the b-th smallest value (exact rank space);
  * one with more: cut points are the ``nearest`` quantiles of its distinct
    values at (1..max_bins-1)/max_bins, those below the largest value kept,
    and a value lands in the first bin whose cut is not below it;
  * a discrete column: the bins are its codes, ``max + 1`` of them.

No unknown values: every generator here makes complete columns.
"""

from __future__ import annotations

import torch


def bin_continuous(col: torch.Tensor, max_bins: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(int32 bins, float64 upper edge of each bin) of one column."""
    domain = torch.unique(col)                      # sorted
    if domain.numel() <= max_bins:
        return (torch.searchsorted(domain, col).to(torch.int32),
                domain.to(torch.float64))
    qs = torch.linspace(0.0, 1.0, max_bins + 1, dtype=torch.float64,
                        device=col.device)[1:-1]
    pos = torch.round(qs * (domain.numel() - 1)).long()
    cut = torch.unique(domain[pos])
    cut = cut[cut < domain[-1]]
    bins = torch.searchsorted(cut, col, right=False).to(torch.int32)
    return bins, torch.cat([cut, domain[-1:]]).to(torch.float64)


def bin_discrete(col: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n_values = int(col.max()) + 1
    return col.to(torch.int32), torch.arange(n_values, dtype=torch.float64)
