"""Seconds a tree: the window's time over the whole trees it built."""


def read(run):
    return run.window_s / run.n_trees
