"""Hand-written CUDA kernels: the splitAtt hot spot and forest inference.

:mod:`.histogram`, :mod:`.split_gain` and :mod:`.tree_infer` launch the
kernels on CUDA tensors; :mod:`.ref` holds their plain versions, and
:mod:`.ops` picks one of the two by the tensors' device (the frontier engine
and the forest pick by their ``impl`` instead).
:mod:`.autotune` sizes the tiles; :mod:`.compaction` feeds the histogram only
the live cases; :mod:`._build` compiles ``csrc/*.cu`` with nvcc at first use.
"""
