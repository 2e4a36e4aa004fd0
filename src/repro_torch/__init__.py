"""PyTorch/CUDA port of the YaDT-FF frontier tree engine, its forest
serving path and the LM serving and training paths.

Mirrors the module layout of the JAX package so each module has a
counterpart of the same name: ``core`` (config, binning, entropy, tree,
frontier, c45, farm, farm_build, simulate, cost_models, scheduler,
faults), ``data`` (QUEST generator, Table-1 stand-ins, the LM token
loader), ``kernels`` (hand-written CUDA histogram, split-gain,
forest-traversal and flash-attention forward and backward kernels for
Hopper, their plain torch versions, and the dispatch between them),
``infer`` (packed forest, model registry, predict service), ``configs``
(yadt, gemma2_9b, yi_6b, gemma3_4b, phi4_mini), ``models`` (layers,
decoder stack, serving cache, loss), ``serve`` (the LM engine and
sampling), ``launch`` (the serving and training drivers), ``obs``
(tracing, metrics, report), ``ensemble`` (sampling, the farm trainer,
OOB, publish) and ``train`` (AdamW, the train step, checkpoints, the
heartbeat, straggler and mesh-planning control plane).  Imports only
torch and numpy.
"""
