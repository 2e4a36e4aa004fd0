"""Observability: span tracing and metrics (copies of the JAX package's
``obs.trace`` and ``obs.metrics``, pure Python).  The predict service is
instrumented through them; the text report renderer is not ported yet."""

from repro_torch.obs.metrics import REGISTRY, Registry  # noqa: F401
from repro_torch.obs.trace import NULL, Tracer  # noqa: F401
