"""The 95th percentile of the window's tree times, each a build from the
call to its tree on the card; None with fewer than 20 trees (no tree lies
beyond it then)."""

import statistics


def read(run):
    if run.n_trees < 20:
        return None
    return statistics.quantiles(run.tree_s, n=100, method="inclusive")[94]
