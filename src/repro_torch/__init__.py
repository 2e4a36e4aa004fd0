"""PyTorch/CUDA port of the YaDT-FF frontier tree engine and its forest
serving path.

Mirrors the module layout of the JAX package so each module has a
counterpart of the same name: ``core`` (config, binning, entropy, tree,
frontier, cost_models, scheduler), ``data`` (QUEST generator, Table-1
stand-ins), ``kernels`` (hand-written CUDA histogram, split-gain and
forest-traversal kernels for Hopper, their plain torch versions, and the
dispatch between them), ``infer`` (packed forest, model registry, predict
service), ``obs`` (tracing and metrics), ``ensemble`` (per-tree sampling)
and ``train`` (the registry's staging GC).  Imports only torch and numpy.
"""
