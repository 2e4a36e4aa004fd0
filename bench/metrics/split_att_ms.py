"""Milliseconds a tree in the program's ``splitAtt`` spans (each ends by
waiting for the card, so it holds the phase's host dispatch and its
device work), over the trees traced by the Tracer alone."""


def read(run):
    if not run.spans or "splitAtt" not in run.spans:
        return None
    return run.span_s("splitAtt") / run.span_trees * 1e3
