"""Ensemble training subsystem: farm-parallel random forests.

Four layers, as the JAX package's ``ensemble``:

  * :mod:`repro_torch.ensemble.sampling` — per-tree bootstrap weights and
    feature subsets as pure functions of ``(seed, tree_id)``, so any worker
    can regenerate any tree's inputs after a crash;
  * :mod:`repro_torch.ensemble.trainer`  — tree-level dispatch over the
    supervised farm (one task per tree; retry / quarantine / worker-death
    semantics inherited), each tree grown by the c45 oracle or the frontier
    engine (the CUDA kernels on the card), identical to the sequential
    per-tree oracle;
  * :mod:`repro_torch.ensemble.oob`      — out-of-bag error and permutation
    variable importance from the bootstrap complements (the traversal
    kernel on the card);
  * :mod:`repro_torch.ensemble.publish`  — pack the forest and atomically
    publish it into the serving registry (:mod:`repro_torch.infer`).
"""

from repro_torch.ensemble.oob import (                            # noqa: F401
    OOBResult, oob_score, permutation_importance)
from repro_torch.ensemble.publish import publish_forest           # noqa: F401
from repro_torch.ensemble.trainer import (                        # noqa: F401
    ForestConfig, QuarantinedTrees, TrainResult, train_forest,
    train_forest_sequential, train_tree)
