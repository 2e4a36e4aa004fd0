"""Milliseconds a tree in ``frontier.build`` outside its supersteps: the
rows' copy to the card, ``init_state``, the loop's host test and the
result's slicing.  The harness's ``tree`` span less the program's
``superstep`` spans, over the trees traced by the Tracer alone."""


def read(run):
    if not run.spans or "superstep" not in run.spans:
        return None
    return ((run.span_s("tree") - run.span_s("superstep")) / run.span_trees
            * 1e3)
