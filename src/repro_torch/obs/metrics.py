"""Process-wide registry of labelled counters, gauges and histograms.

A deliberately small, dependency-free metrics core (the shape follows the
Prometheus client model):

  * :class:`Counter`   — monotonically increasing totals
    (``farm_events_total{event="retry"}``);
  * :class:`Gauge`     — last-written values
    (``frontier_active_cases``, ``heartbeat_hosts_alive``);
  * :class:`Histogram` — bucketed distributions with sum/count
    (``engine_queue_wait_ticks``).

Every metric takes free-form keyword labels per observation; each distinct
label combination is its own series.  :data:`REGISTRY` is the process-wide
default written to by the instrumented runtimes; benchmarks and tests may
pass their own :class:`Registry` for isolation.  ``snapshot()`` returns a
plain-JSON structure (committed next to ``BENCH_*`` baselines and diffed
by ``benchmarks/check_regression.py``).
"""

from __future__ import annotations

import threading
from typing import Any, Iterable

#: Default histogram buckets: log-ish ladder wide enough for both seconds
#: (kernel phases) and ticks (engine latencies).
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5,
                   1.0, 5.0, 10.0, 50.0, 100.0, 500.0, 1000.0)


def _key(labels: dict[str, Any]) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Metric:
    kind = "metric"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: dict[tuple, Any] = {}

    def labels_of(self) -> list[dict]:
        with self._lock:
            return [dict(k) for k in self._series]

    def _snapshot_series(self) -> list[dict]:
        raise NotImplementedError


class Counter(Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        k = _key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._series.get(_key(labels), 0.0)

    def _snapshot_series(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in self._series.items()]


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._series[_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels: Any) -> None:
        k = _key(labels)
        with self._lock:
            self._series[k] = self._series.get(k, 0.0) + amount

    def value(self, **labels: Any) -> float:
        with self._lock:
            return self._series.get(_key(labels), 0.0)

    def _snapshot_series(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in self._series.items()]


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help)
        self.buckets = tuple(sorted(buckets))
        if not self.buckets:
            raise ValueError(f"histogram {self.name}: needs >= 1 bucket")

    def observe(self, value: float, **labels: Any) -> None:
        k = _key(labels)
        with self._lock:
            st = self._series.get(k)
            if st is None:
                st = self._series[k] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0}
            i = len(self.buckets)                     # +inf overflow bucket
            for j, le in enumerate(self.buckets):
                if value <= le:
                    i = j
                    break
            st["counts"][i] += 1
            st["sum"] += value
            st["count"] += 1

    def quantile(self, q: float, **labels: Any) -> float:
        """Bucket-upper-bound estimate of the q-quantile (q in [0, 1])."""
        with self._lock:
            st = self._series.get(_key(labels))
            if st is None or not st["count"]:
                return float("nan")
            rank = q * st["count"]
            seen = 0
            for j, n in enumerate(st["counts"]):
                seen += n
                if seen >= rank and n:
                    return (self.buckets[j] if j < len(self.buckets)
                            else float("inf"))
            return float("inf")

    def _snapshot_series(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(k), "buckets": list(self.buckets),
                     "counts": list(st["counts"]), "sum": st["sum"],
                     "count": st["count"]}
                    for k, st in self._series.items()]


class Registry:
    """Named metric store; getters are idempotent and kind-checked."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: dict[str, Metric] = {}

    def _get(self, cls, name: str, help: str, **kw: Any) -> Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name: str) -> Metric | None:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> dict[str, dict]:
        """JSON-able view of every metric: kind, help, per-label series."""
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"kind": m.kind, "help": m.help,
                         "series": m._snapshot_series()}
                for m in metrics}

    def reset(self) -> None:
        """Drop every registered metric (tests / fresh benchmark runs)."""
        with self._lock:
            self._metrics.clear()


#: Process-wide default registry: the instrumented runtimes write here
#: unless handed an explicit one.
REGISTRY = Registry()
