"""Growth parameters of the torch frontier engine (the JAX package's
``GrowConfig`` less the fields that only its bucket ladder, its strategy
switch and its Pallas attribute tiles read)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class GrowConfig:
    """Parameters of the C4.5 growth phase (paper Sect. 3.1).

    Attributes:
      min_objs: C4.5 MINOBJS — a node needs weight >= 2*min_objs to split and
        each side of a continuous split needs weight >= min_objs.
      criterion: "gain" (paper footnote 3) or "gain_ratio" (full C4.5).
      max_depth: safety bound on tree depth.
      max_nodes: tree array capacity (frontier engine; oracle grows freely).
      frontier_slots: K — max nodes processed per superstep by the frontier
        engine (the batched analogue of the farm's in-flight task window).
      unknown_fractional: True = full C4.5 semantics, unknown-valued cases go
        to every child with rebalanced weights (sequential oracle only);
        False = route unknowns to the heaviest child (the frontier engine's
        rule).
      cost_model: buildAttTest variant for NP/NAP switching: "nsq" (|T|<c·r²,
        paper's best), "nlogn" (|T|<c·r·log r), "alpha" (α<r).
      alpha: the α of the "alpha" cost model (paper uses 1000).
      compact: gather the live cases (slot >= 0) into a dense buffer before
        the histogram, so deep supersteps cost O(live) instead of O(N)
        (see repro_torch.kernels.compaction).
      block_t/block_k/block_b: pinned CUDA tile sizes: cases per
        histogram block (t), slots per shared-memory sub-histogram (k) and
        threads of a split-gain block (b).  None = shape-driven heuristic
        (repro_torch.kernels.autotune).
    """

    min_objs: float = 2.0
    criterion: str = "gain"
    max_depth: int = 64
    max_nodes: int = 1 << 15
    frontier_slots: int = 256
    unknown_fractional: bool = False
    cost_model: str = "nsq"
    alpha: float = 1000.0
    compact: bool = True
    block_t: int | None = None
    block_k: int | None = None
    block_b: int | None = None
