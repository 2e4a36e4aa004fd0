"""The paper's own workload as a first-class config: YaDT-FF tree growth.

``yadt`` selects the frontier engine over the SyD10M9A schema (paper
Table 1): 10M cases, 9 attributes, 256 bins, and the grow configuration
(2^18 nodes, 256 frontier slots) every full-size run of the port uses.  A
copy of the JAX package's ``configs.yadt``.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.core.config import GrowConfig


@dataclasses.dataclass(frozen=True)
class YaDTWorkload:
    n_cases: int = 10_000_000
    n_attrs: int = 9
    n_bins: int = 256
    n_classes: int = 2
    max_children: int = 20          # widest discrete split (car: 20 values)
    grow: GrowConfig = GrowConfig(max_nodes=1 << 18, frontier_slots=256)


WORKLOAD = YaDTWorkload()

CONFIG = ModelConfig(
    name="yadt", family="tree",
    n_layers=0, d_model=0, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=0,
    notes="paper technique itself; dry-run lowers one frontier superstep "
          "with cases sharded over data x attributes over model (NAP).",
)
