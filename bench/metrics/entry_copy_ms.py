"""Milliseconds a tree in the program's ``entry.copy`` spans: the rows,
labels, weights and attribute tables copied to the card at the build's
entry (pageable, so the host waits for each copy), over the trees traced
by the Tracer alone."""


def read(run):
    if not run.spans or "entry.copy" not in run.spans:
        return None
    return run.span_s("entry.copy") / run.span_trees * 1e3
