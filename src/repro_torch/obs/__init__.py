"""Observability: span tracing, metrics and the text report (copies of
the JAX package's ``obs.trace``, ``obs.metrics`` and ``obs.report``, pure
Python).  The predict service, the farm and the frontier build are
instrumented through them; ``report.render`` summarises a run."""

from repro_torch.obs import report  # noqa: F401
from repro_torch.obs.metrics import REGISTRY, Registry  # noqa: F401
from repro_torch.obs.trace import NULL, Tracer  # noqa: F401
