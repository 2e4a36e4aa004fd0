"""The inputs a generator makes: binned columns on the device."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Data:
    x: torch.Tensor                 # int32 (N, A) bins
    y: torch.Tensor                 # int64 (N,) classes
    attr_is_cont: list[bool]
    n_bins: list[int]               # live bins of each attribute
    bin_edges: list[torch.Tensor]   # float64 upper edge of each bin
    n_classes: int
    attr_names: list[str]

    @property
    def n_cases(self) -> int:
        return int(self.x.shape[0])



def stack(columns: list[tuple[torch.Tensor, torch.Tensor]], y: torch.Tensor,
          *, attr_is_cont: list[bool], n_classes: int,
          attr_names: list[str]) -> Data:
    """A :class:`Data` from binned columns ``(bins, edges)``."""
    return Data(
        x=torch.stack([b for b, _ in columns], dim=1).contiguous(),
        y=y.to(torch.int64), attr_is_cont=list(attr_is_cont),
        n_bins=[max(int(e.numel()), 1) for _, e in columns],
        bin_edges=[e.cpu() for _, e in columns], n_classes=int(n_classes),
        attr_names=list(attr_names))


def permuted(data: Data, seed: int) -> Data:
    """The same cases in the order a ``torch.Generator`` seeded with
    ``seed`` draws: another order of one set of cases, so every seed asks
    the build for the same work."""
    g = torch.Generator(device=data.x.device)
    g.manual_seed(int(seed))
    order = torch.randperm(data.n_cases, generator=g, device=data.x.device)
    return dataclasses.replace(data, x=data.x[order].contiguous(),
                               y=data.y[order])
