"""The build's share of the H100's peak, in %: the least time of the
algorithmic work of the window's trees (``bench.work``: each scored
node's cases read once, its histogram written and read once, at 3.35
TB/s, or its operations at 67 TFLOP/s f32, whichever is longer) over the
time of the trees traced by the Tracer alone."""


def read(run):
    if not run.spans or "tree" not in run.spans:
        return None
    return 100 * run.work.build_s() * run.span_trees / run.span_s("tree")
