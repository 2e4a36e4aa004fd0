"""Text summary renderer for a traced/metered run (the JAX package's
``obs.report``, pure Python).

``render(tracer=..., metrics=..., farm_stats=...)`` produces the human
"where did the time go" view the paper's figures are built from:

  * span breakdown — per-name count/total/mean/max, with the superstep
    phases (``splitPre``/``splitAtt``/``splitPost``) as ordinary rows;
  * counter timelines — unicode sparklines of ``ph="C"`` series, e.g. the
    per-worker queued-weight trajectory behind Fig. 13's balance argument;
  * metrics — counters and gauges as lines, histograms as bar charts with
    p50/p90/p99 (request queue-wait and decode latency);
  * farm stats — emitter-busy %, per-worker busy seconds and task counts
    (paper Fig. 14's execution breakdown) straight from ``Farm.stats()``
    (its ``worker_busy`` / ``emitter_busy`` keys).

Everything degrades gracefully: sections with no data are omitted.  The
same sources give the same text as the JAX package's renderer.
"""

from __future__ import annotations

from typing import Any

_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values: list[float], width: int = 48) -> str:
    if not values:
        return ""
    if len(values) > width:                      # downsample by striding
        step = len(values) / width
        values = [values[int(i * step)] for i in range(width)]
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))]
                   for v in values)


def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:8.3f}s "
    if us >= 1e3:
        return f"{us / 1e3:8.2f}ms"
    return f"{us:8.1f}us"


def _span_section(tracer) -> list[str]:
    summary = tracer.span_summary()
    if not summary:
        return []
    wall = 0.0
    for ev in tracer.events:
        if ev.get("ph") == "X":
            wall = max(wall, ev["ts"] + ev["dur"])
    lines = ["== spans ==",
             f"{'name':<28}{'count':>7}{'total':>11}{'mean':>11}"
             f"{'max':>11}{'%wall':>7}"]
    for name, s in sorted(summary.items(),
                          key=lambda kv: -kv[1]["total_us"]):
        pct = 100.0 * s["total_us"] / wall if wall else 0.0
        lines.append(f"{name:<28}{s['count']:>7.0f}"
                     f"{_fmt_us(s['total_us']):>11}"
                     f"{_fmt_us(s['mean_us']):>11}"
                     f"{_fmt_us(s['max_us']):>11}{pct:>6.1f}%")
    return lines


def _counter_section(tracer) -> list[str]:
    series = tracer.counter_series()
    if not series:
        return []
    lines = ["", "== counter timelines =="]
    for name, points in sorted(series.items()):
        for field in sorted({k for _, vals in points for k in vals}):
            vals = [v[field] for _, v in points if field in v]
            label = name if field in ("value", "weight") else f"{name}.{field}"
            lines.append(f"{label:<28}last={vals[-1]:<10.4g}"
                         f"max={max(vals):<10.4g}{_sparkline(vals)}")
    return lines


def _histogram_lines(name: str, s: dict, width: int = 30) -> list[str]:
    counts, buckets = s["counts"], s["buckets"]
    total = s["count"]
    if not total:
        return []
    label = ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items()))
    mean = s["sum"] / total

    def q(frac: float) -> str:
        rank, seen = frac * total, 0
        for j, n in enumerate(counts):
            seen += n
            if seen >= rank and n:
                return f"{buckets[j]:g}" if j < len(buckets) else "inf"
        return "inf"

    head = (f"{name}{{{label}}}" if label else name)
    lines = [f"{head}  count={total} mean={mean:.4g} "
             f"p50<={q(.5)} p90<={q(.9)} p99<={q(.99)}"]
    peak = max(counts)
    for j, n in enumerate(counts):
        if not n:
            continue
        le = f"<= {buckets[j]:g}" if j < len(buckets) else "> last"
        bar = "#" * max(1, int(n / peak * width))
        lines.append(f"  {le:>12} {bar} {n}")
    return lines


def _metrics_section(metrics) -> list[str]:
    snap = metrics.snapshot() if metrics is not None else {}
    if not snap:
        return []
    lines = ["", "== metrics =="]
    for name, m in sorted(snap.items()):
        if m["kind"] == "histogram":
            for s in m["series"]:
                lines.extend(_histogram_lines(name, s))
            continue
        for s in m["series"]:
            label = ",".join(f"{k}={v}"
                             for k, v in sorted(s["labels"].items()))
            head = f"{name}{{{label}}}" if label else name
            lines.append(f"{head:<44}{s['value']:g}")
    return lines


def _farm_section(stats: dict[str, Any]) -> list[str]:
    if not stats:
        return []
    busy = stats.get("worker_busy", [])
    tasks = stats.get("worker_tasks", [])
    dead = set(stats.get("dead_workers", []))
    total_busy = sum(busy) or 1.0
    wall = max(busy) if busy else 0.0
    emitter = stats.get("emitter_busy", 0.0)
    pct = 100.0 * emitter / wall if wall else 0.0
    lines = ["", "== farm ==",
             f"emitter busy {emitter:.4f}s ({pct:.1f}% of the longest "
             f"worker lane)"]
    for i, b in enumerate(busy):
        n = tasks[i] if i < len(tasks) else 0
        mark = " DEAD" if i in dead else ""
        bar = "#" * max(1, int(b / total_busy * 40)) if b > 0 else ""
        lines.append(f"  w{i:<3} {b:8.4f}s {n:>6} tasks {bar}{mark}")
    for k in ("failures", "retries", "requeues", "timeouts",
              "quarantined", "dropped_late"):
        if stats.get(k):
            lines.append(f"  {k}: {stats[k]}")
    return lines


def render(tracer=None, metrics=None, farm_stats: dict | None = None) -> str:
    """One text report over whatever sources are provided."""
    lines: list[str] = []
    if tracer is not None:
        lines += _span_section(tracer)
        lines += _counter_section(tracer)
    lines += _metrics_section(metrics)
    if farm_stats:
        lines += _farm_section(farm_stats)
    return "\n".join(lines) if lines else "(no observability data)"
