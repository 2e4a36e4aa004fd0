"""PyTorch/CUDA port of the YaDT-FF frontier tree engine, its forest
serving path and the LM serving path.

Mirrors the module layout of the JAX package so each module has a
counterpart of the same name: ``core`` (config, binning, entropy, tree,
frontier, cost_models, scheduler, faults), ``data`` (QUEST generator,
Table-1 stand-ins), ``kernels`` (hand-written CUDA histogram, split-gain,
forest-traversal and flash-attention kernels for Hopper, their plain torch
versions, and the dispatch between them), ``infer`` (packed forest, model
registry, predict service), ``configs`` (gemma2_9b, yi_6b), ``models``
(layers, decoder stack, serving cache; forward only), ``serve`` (the LM
engine and sampling), ``launch`` (the serving driver), ``obs`` (tracing and
metrics), ``ensemble`` (per-tree sampling) and ``train`` (the registry's
staging GC and the heartbeat monitor).  Imports only torch and numpy.
"""
