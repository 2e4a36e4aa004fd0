"""Milliseconds a tree in the program's ``compact`` spans: splitAtt's
gather of the live cases ahead of the histogram (the ``nonzero`` over
every case's slot, where the host waits for the card, and the gathers of
the live rows, labels, weights and slots), over the trees traced by the
Tracer alone.  None where the program has no such span."""


def read(run):
    if not run.spans or "compact" not in run.spans:
        return None
    return run.span_s("compact") / run.span_trees * 1e3
