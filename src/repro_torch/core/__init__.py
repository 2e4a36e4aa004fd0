"""The paper's contribution: farm-parallel C4.5 decision-tree induction.

Public surface:

  binning.fit / BinnedDataset   — EC4.5 rank-space representation
  c45.build                     — sequential YaDT oracle (the reference)
  frontier.build                — level-synchronous frontier engine (the
                                  CUDA splitAtt kernels on the card)
  frontier.build_farm           — fault-tolerant threaded-farm build
  GrowConfig                    — growth parameters
  farm.Farm, FaultPolicy        — supervised farm-with-feedback runtime
  faults.FaultInjector          — deterministic crash/hang/slow injection
  scheduler.*                   — DRR/OD/WS/HealthWS policies
  simulate.simulate             — discrete-event farm replay (paper figures)
"""

from repro_torch.core.binning import (BinnedDataset, fit,  # noqa: F401
                                      from_binned)
from repro_torch.core.config import GrowConfig  # noqa: F401
from repro_torch.core.farm import (AllWorkersDead, Farm,  # noqa: F401
                                   FaultPolicy, TaskFailure, WorkerCrashed)
from repro_torch.core.tree import Tree, predict, trees_equal  # noqa: F401
