"""The host's waits for the card a superstep: the program's ``wait.*``
spans over its ``superstep`` spans, in the trees traced by the Tracer
alone."""


def read(run):
    waits = [n for n in (run.spans or {}) if n.startswith("wait.")]
    if not waits or "superstep" not in run.spans:
        return None
    return (sum(len(run.spans[n]) for n in waits)
            / len(run.spans["superstep"]))
