"""Batched tree-inference serving on torch tensors.

Three layers, as in the JAX package:

  * :mod:`repro_torch.infer.forest`   -- pack trees into a padded
    structure-of-arrays :class:`Forest`; batched prediction through the
    CUDA traversal kernel or its plain version; ensemble vote.
  * :mod:`repro_torch.infer.registry` -- versioned on-disk model registry
    (the JAX package's format) with atomic publish, checksum verification
    and a hot-swap :class:`ModelHandle` (canary / shadow routing).
  * :mod:`repro_torch.infer.service`  -- microbatching predict front-end
    over a fleet of replicas, scheduled by the paper's farm policies.
"""

from repro_torch.infer.forest import (  # noqa: F401
    Forest, forest_from_numpy, predict, predict_per_tree)
from repro_torch.infer.registry import ModelHandle  # noqa: F401
from repro_torch.infer.service import (  # noqa: F401
    BatchPredictService, InferReplica, PredictRequest)
