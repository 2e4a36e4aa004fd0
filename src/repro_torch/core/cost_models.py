"""The paper's ``buildAttTest`` cost models (Sect. 4) on torch tensors.

Given a node with ``r`` training cases and ``c`` active attributes, decide
whether to parallelise over attributes (NAP, True) or over nodes (NP,
False); ``|T|`` is the whole training-set size:

  alpha :  α < r
  nlogn :  |T| < c·r·log2(r)
  nsq   :  |T| < c·r²

The frontier engine sums the decisions into its ``nap_nodes`` statistic;
the farm simulator (:mod:`repro_torch.core.simulate`) takes one per split
node, and ``task_grain`` is the paper's grain of a node task, on plain
Python floats.
"""

from __future__ import annotations

import math

import torch

COST_MODELS = ("alpha", "nlogn", "nsq")


def build_att_test(model: str, *, n_total_cases: float, r, c,
                   alpha: float = 1000.0) -> torch.Tensor:
    """True where the node should use attribute parallelisation (NAP)."""
    r = torch.as_tensor(r).to(torch.float32)
    c = torch.as_tensor(c).to(torch.float32)
    if model == "alpha":
        return r > alpha
    if model == "nlogn":
        return n_total_cases < c * r * torch.log2(torch.clamp_min(r, 2.0))
    if model == "nsq":
        return n_total_cases < c * r * r
    raise ValueError(f"unknown cost model {model!r}; choose from {COST_MODELS}")


def task_grain(model: str, *, r: float, c: float) -> float:
    """Analytic node-processing grain used by the simulator's cost table.

    The paper models node::split as quicksort-dominated: average c·r·log r,
    worst-case c·r².  ``task_grain`` returns the average-case estimate (the
    simulator calibrates the constant from measured oracle timings).
    """
    r = max(float(r), 1.0)
    return float(c) * r * max(math.log2(r), 1.0)
