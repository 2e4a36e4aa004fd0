"""Milliseconds a tree in the program's ``kernel.histogram`` and
``kernel.split_gain`` spans: the host's calls of splitAtt's two kernels
(their wrappers, the launches, and on the plain path the torch ops), over
the trees traced by the Tracer alone."""

SPANS = ("kernel.histogram", "kernel.split_gain")


def read(run):
    if not run.spans or not any(n in run.spans for n in SPANS):
        return None
    return sum(run.span_s(n) for n in SPANS) / run.span_trees * 1e3
