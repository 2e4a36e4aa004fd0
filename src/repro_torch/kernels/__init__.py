"""Hand-written CUDA kernels: the splitAtt hot spot, splitPost, forest
inference and the flash-attention forward of the LM prefill.

:mod:`.histogram`, :mod:`.split_gain`, :mod:`.tree_infer` and
:mod:`.flash_attention` launch the kernels on CUDA tensors; :mod:`.ref`
holds their plain versions, and :mod:`.ops` picks one of the two by the
tensors' device (the frontier engine, the forest and the LM pick by their
``impl`` instead).  :mod:`.autotune` sizes the tiles; :mod:`.compaction`
feeds the histogram only the live cases; :mod:`._build` compiles
``csrc/*.cu`` with nvcc at first use.  Each launch is a custom op
(``torch.ops.repro_torch.*``): on meta tensors it returns empty outputs
and counts the kernel's own work (``launch.roofline``); on DTensors it
runs on each rank's shards by its registered sharding strategy
(:mod:`._dtensor`: CPU shards reach the op's plain CPU kernel).
:mod:`.split_post` is the exception: splitPost's two kernels update the
frontier engine's state in place, a plain call with no custom op; its
plain version is the torch body of ``core.frontier.split_post``.
"""
