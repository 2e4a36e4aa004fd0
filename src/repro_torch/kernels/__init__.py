"""Hand-written CUDA kernels for the splitAtt hot spot.

:mod:`.histogram` and :mod:`.split_gain` launch the kernels on CUDA tensors;
:mod:`.ref` holds their plain versions, and :mod:`.ops` picks one of the two
by the tensors' device (the frontier engine picks by its ``impl`` instead).
:mod:`.autotune` sizes the tiles; :mod:`.compaction` feeds the histogram only
the live cases; :mod:`._build` compiles ``csrc/*.cu`` with nvcc at first use.
"""
