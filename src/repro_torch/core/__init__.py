"""Tree growth: rank-space data, the C4.5 scorer, the array tree and the
level-synchronous frontier engine."""
