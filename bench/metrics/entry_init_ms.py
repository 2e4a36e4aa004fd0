"""Milliseconds a tree in the program's ``entry.init`` spans: the
initial state (the root's class counts over every case) and the loop's
first test, whose wait holds that device work, over the trees traced by
the Tracer alone."""


def read(run):
    if not run.spans or "entry.init" not in run.spans:
        return None
    return run.span_s("entry.init") / run.span_trees * 1e3
