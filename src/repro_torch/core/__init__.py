"""Tree growth: rank-space data, the C4.5 scorer, the array tree, the
level-synchronous frontier engine and the farm's scheduling policies."""
