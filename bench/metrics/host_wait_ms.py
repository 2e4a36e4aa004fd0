"""Milliseconds a tree in the program's ``wait.*`` spans, each around a
read where the host waits for the card (the loop's test, the frontier's
and the compaction's ``nonzero``, the status writes from a host scalar,
the statistics' one read after the loop), over the trees traced by the
Tracer alone."""


def read(run):
    waits = [n for n in (run.spans or {}) if n.startswith("wait.")]
    if not waits:
        return None
    return sum(run.span_s(n) for n in waits) / run.span_trees * 1e3
