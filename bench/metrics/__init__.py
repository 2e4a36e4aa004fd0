"""One reader a metric, ``<name>.py``: ``read(run)`` returns the metric's
value from a :class:`bench.harness.Run`, or None where the run holds
nothing to read it from (the harness then leaves the metric out)."""
