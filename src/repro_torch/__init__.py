"""PyTorch/CUDA port of the YaDT-FF frontier tree engine.

Mirrors the module layout of the JAX package so each module has a
counterpart of the same name: ``core`` (config, binning, entropy, tree,
frontier, cost_models), ``data`` (QUEST generator, Table-1 stand-ins) and
``kernels`` (hand-written CUDA histogram and split-gain kernels for Hopper,
their plain torch versions, and the dispatch between them).  Imports only
torch and numpy.
"""
