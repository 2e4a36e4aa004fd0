"""Thread-safe span tracer with Chrome-trace-event JSON export.

Produces the `Trace Event Format`_ consumed by Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing``:

  * :meth:`Tracer.span` — nestable duration spans (``ph="X"``); nesting is
    per-thread, so farm workers show up as separate lanes;
  * :meth:`Tracer.instant` — point events (retries, evictions, deaths);
  * :meth:`Tracer.counter` — numeric time series (per-worker queued
    weight), rendered by Perfetto as a stacked timeline;
  * :meth:`Tracer.begin` / :meth:`Tracer.end` — async spans that may cross
    threads and overlap (one per serving request, keyed by uid).

Zero-cost when disabled: every method checks ``self.enabled`` first and
returns a shared no-op, so instrumented hot paths (the farm worker loop,
the engine tick) pay one attribute load + branch.  :data:`NULL` is the
process-wide disabled tracer used as the default everywhere.

.. _Trace Event Format:
   https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    """One open duration span; emits a single complete ("X") event on exit.
    ``ts``: its start on the tracer's clock (us), once entered."""

    __slots__ = ("_tracer", "_name", "_args", "ts")

    def __init__(self, tracer: "Tracer", name: str, args: dict | None):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self) -> "_Span":
        self.ts = self._tracer._now_us()
        return self

    def __exit__(self, *exc: Any) -> bool:
        tr = self._tracer
        t1 = tr._now_us()
        ev = {"name": self._name, "ph": "X", "ts": self.ts,
              "dur": t1 - self.ts, "pid": tr._pid, "tid": tr._tid()}
        if self._args:
            ev["args"] = self._args
        tr._emit(ev)
        return False


class Tracer:
    """Collects trace events in memory; thread-safe; export via :meth:`save`.

    ``enabled=False`` turns every call into a cheap no-op — construct one
    tracer per run you want to inspect and pass it down; the default
    everywhere is the disabled :data:`NULL`.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._epoch = time.perf_counter()
        self._pid = os.getpid()
        self._tid_map: dict[int, int] = {}

    # ----------------------------------------------------------- internals
    def _now_us(self) -> float:
        return (time.perf_counter() - self._epoch) * 1e6

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tid_map.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tid_map.setdefault(ident, len(self._tid_map) + 1)
                self._events.append({
                    "name": "thread_name", "ph": "M", "pid": self._pid,
                    "tid": tid,
                    "args": {"name": threading.current_thread().name}})
        return tid

    def _emit(self, ev: dict) -> None:
        with self._lock:
            self._events.append(ev)

    # ------------------------------------------------------------- emitters
    def span(self, name: str, **args: Any):
        """Context manager timing a nested duration span on this thread."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, args or None)

    def instant(self, name: str, **args: Any) -> None:
        """A point event (``ph="i"``): retries, evictions, deaths, ..."""
        if not self.enabled:
            return
        ev = {"name": name, "ph": "i", "s": "t", "ts": self._now_us(),
              "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def counter(self, name: str, *, ts: float | None = None,
                **values: float) -> None:
        """A counter sample (``ph="C"``): Perfetto draws a value timeline.
        ``ts`` stamps it at an earlier time on this clock (a span's
        ``ts``, for a value read later); default now."""
        if not self.enabled:
            return
        self._emit({"name": name, "ph": "C",
                    "ts": self._now_us() if ts is None else ts,
                    "pid": self._pid, "tid": self._tid(), "args": values})

    def begin(self, name: str, id: int, **args: Any) -> None:
        """Open an async span (``ph="b"``) — may overlap and cross threads."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": "async", "ph": "b", "id": id,
              "ts": self._now_us(), "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._emit(ev)

    def end(self, name: str, id: int, **args: Any) -> None:
        """Close the async span opened by :meth:`begin` with the same id."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": "async", "ph": "e", "id": id,
              "ts": self._now_us(), "pid": self._pid, "tid": self._tid()}
        if args:
            ev["args"] = args
        self._emit(ev)

    # ------------------------------------------------------------ consumers
    @property
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def to_chrome(self) -> dict:
        """The JSON-object trace form Perfetto/chrome://tracing load."""
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path

    def span_summary(self) -> dict[str, dict[str, float]]:
        """Aggregate duration spans by name: count/total/mean/max (us)."""
        out: dict[str, dict[str, float]] = {}
        for ev in self.events:
            if ev.get("ph") != "X":
                continue
            s = out.setdefault(ev["name"],
                               {"count": 0, "total_us": 0.0, "max_us": 0.0})
            s["count"] += 1
            s["total_us"] += ev["dur"]
            s["max_us"] = max(s["max_us"], ev["dur"])
        for s in out.values():
            s["mean_us"] = s["total_us"] / max(s["count"], 1)
        return out

    def counter_series(self) -> dict[str, list[tuple[float, dict]]]:
        """Counter samples grouped by name as ``[(ts_us, values), ...]``."""
        out: dict[str, list[tuple[float, dict]]] = {}
        for ev in self.events:
            if ev.get("ph") == "C":
                out.setdefault(ev["name"], []).append((ev["ts"], ev["args"]))
        for series in out.values():
            series.sort(key=lambda p: p[0])
        return out


#: Process-wide disabled tracer — the default for every instrumented path.
NULL = Tracer(enabled=False)
