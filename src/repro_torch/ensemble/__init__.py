"""Forest ensembles.  Only :mod:`.sampling` (per-tree bootstrap weights and
feature subsets, numpy only) is ported so far; the trainer, OOB scoring and
publish come in a later slice."""
