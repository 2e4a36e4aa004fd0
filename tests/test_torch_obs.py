"""The port's text report and the traced frontier build against the JAX
package's.

``repro_torch.obs.report.render`` must give the JAX renderer's text for the
same sources: no source at all, a port ``Tracer`` and a JAX ``Tracer``
holding the same event list, registries fed the same observations, and the
same farm stats.  ``repro_torch.core.frontier.build(tracer=..., metrics=...)``
must grow the untraced tree and the JAX traced build's tree
(``impl="jnp"``, on the CPU), with the JAX rows on the JAX keys, the JAX
build's span names among its own (one ``superstep`` / ``splitPre`` /
``splitAtt`` / ``splitPost`` span a superstep), the JAX registry's
counters and gauges (and no ``frontier_phase_seconds``), and the JAX
``frontier.n_active`` counter values.  Its span tree: ``entry.copy`` and
``entry.init`` once, in each superstep one ``wait.frontier``,
``compact`` (holding ``wait.compact``), ``kernel.histogram``, ``kernel.split_gain``,
``wait.status`` and ``wait.loop``, the root's status write and the loop's
first test in ``entry.init``, one ``wait.stats`` after the loop, every span inside its parent on one thread; the
statistics read once, not a superstep at a time.  The report and tracing
cases of ``tests/test_obs.py`` run through the port.  The traced build on
the card (``impl="cuda"``) is a ``cuda`` test in
``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from conftest import make_tree_dataset
from repro.core import frontier as jfrontier
from repro.core.config import GrowConfig as JaxGrowConfig
from repro.obs import report as jreport
from repro.obs.metrics import Registry as JaxRegistry
from repro.obs.trace import Tracer as JaxTracer
from repro_torch.core import frontier
from repro_torch.core.config import GrowConfig
from repro_torch.core.tree import trees_equal
from repro_torch.obs import report
from repro_torch.obs.metrics import Registry
from repro_torch.obs.trace import NULL, Tracer

pytestmark = pytest.mark.timeout(300)

PHASES = ("splitPre", "splitAtt", "splitPost")
SPANS = ("superstep", *PHASES)
GAUGES_AND_COUNTERS = ("frontier_supersteps_total", "frontier_active_cases",
                       "frontier_open_nodes", "frontier_nap_nodes_total",
                       "frontier_children_total")


# ----------------------------------------------------------------- report

def _events(seed: int) -> list[dict]:
    """A run's worth of events: nested spans on two threads, instants,
    counters with one and several fields, async spans, thread names."""
    rng = np.random.default_rng(seed)
    ev, ts = [], 0.0
    for tid in (1, 2):
        ev.append({"name": "thread_name", "ph": "M", "pid": 7, "tid": tid,
                   "args": {"name": f"worker-{tid}"}})
    for step in range(int(rng.integers(5, 40))):
        dur = float(rng.uniform(1, 3e6))
        ev.append({"name": "superstep", "ph": "X", "ts": ts, "dur": dur,
                   "pid": 7, "tid": 1, "args": {"step": step}})
        sub = ts
        for name in PHASES:
            d = float(rng.uniform(0, dur / 3))
            ev.append({"name": name, "ph": "X", "ts": sub, "dur": d,
                       "pid": 7, "tid": 1})
            sub += d
        ev.append({"name": "task", "ph": "X", "ts": ts + 5.0,
                   "dur": float(rng.uniform(0.1, 900.0)), "pid": 7,
                   "tid": 2})
        ev.append({"name": "frontier.n_active", "ph": "C", "ts": ts,
                   "pid": 7, "tid": 1,
                   "args": {"value": int(rng.integers(0, 10_000))}})
        ev.append({"name": "w0.queue", "ph": "C", "ts": ts + 1.0, "pid": 7,
                   "tid": 2, "args": {"weight": float(rng.uniform(0, 5)),
                                      "tasks": int(rng.integers(0, 9))}})
        if step % 3 == 0:
            ev.append({"name": "retry", "ph": "i", "s": "t", "ts": ts,
                       "pid": 7, "tid": 2, "args": {"task": step}})
        ev.append({"name": "req", "cat": "async", "ph": "b", "id": step,
                   "ts": ts, "pid": 7, "tid": 1})
        ev.append({"name": "req", "cat": "async", "ph": "e", "id": step,
                   "ts": ts + dur, "pid": 7, "tid": 2})
        ts += dur + float(rng.uniform(0, 100))
    return ev


def _feed(reg, seed: int) -> None:
    """The same observations into either package's registry."""
    rng = np.random.default_rng(seed)
    steps = reg.counter("frontier_supersteps_total")
    events = reg.counter("farm_events_total", "e")
    gauge = reg.gauge("frontier_active_cases")
    hist = reg.histogram("engine_queue_wait_ticks", "w")
    phase = reg.histogram("frontier_phase_seconds", "per phase")
    small = reg.histogram("tiny", buckets=(0.5, 1.0))
    for _ in range(int(rng.integers(10, 60))):
        steps.inc()
        events.inc(float(rng.integers(1, 3)),
                   event=("retry", "crash")[int(rng.integers(2))])
        gauge.set(float(rng.integers(0, 10**7)))
        hist.observe(float(rng.exponential(20.0)))
        phase.observe(float(rng.exponential(0.01)),
                      phase=PHASES[int(rng.integers(3))])
        small.observe(float(rng.uniform(0, 2)))
    reg.gauge("heartbeat_hosts_alive").set(3.0, host="a")
    reg.gauge("heartbeat_hosts_alive").inc(2.0, host="b")


FARM_STATS = {"n_workers": 3, "tasks": 12, "retries": 2, "failures": 3,
              "requeues": 1, "timeouts": 0, "quarantined": 1,
              "dead_workers": [2], "worker_busy": [0.5, 0.25, 0.0],
              "worker_tasks": [7, 5, 0], "emitter_busy": 0.125,
              "worker_busy_s": [9.0], "emitter_busy_s": 9.0}


def _with_events(tracer, events):
    tracer._events = [dict(e) for e in events]
    return tracer


def test_render_with_no_source_equals_jax():
    assert report.render() == jreport.render()
    assert report.render(tracer=Tracer(), metrics=Registry(),
                         farm_stats={}) == jreport.render(
        tracer=JaxTracer(), metrics=JaxRegistry(), farm_stats={})
    assert "no observability data" in report.render()


@pytest.mark.parametrize("seed", range(4))
def test_render_equals_jax_on_the_same_sources(seed):
    ev = _events(seed)
    reg, jreg = Registry(), JaxRegistry()
    _feed(reg, seed)
    _feed(jreg, seed)
    assert reg.snapshot() == jreg.snapshot()
    for kw in (dict(tracer=True), dict(metrics=True), dict(farm=True),
               dict(tracer=True, metrics=True, farm=True)):
        got = report.render(
            tracer=_with_events(Tracer(), ev) if "tracer" in kw else None,
            metrics=reg if "metrics" in kw else None,
            farm_stats=FARM_STATS if "farm" in kw else None)
        want = jreport.render(
            tracer=_with_events(JaxTracer(), ev) if "tracer" in kw else None,
            metrics=jreg if "metrics" in kw else None,
            farm_stats=FARM_STATS if "farm" in kw else None)
        assert got == want, kw


def test_report_renders_empty_and_full():
    """``tests/test_obs.py``'s report case, on the port."""
    assert "no observability data" in report.render()
    tr = Tracer()
    reg = Registry()
    with tr.span("superstep"):
        pass
    tr.counter("w0.queued_weight", weight=2.0)
    reg.counter("farm_events_total", "e").inc(event="retry")
    reg.histogram("engine_queue_wait_ticks", "w").observe(3.0)
    txt = report.render(tracer=tr, metrics=reg,
                        farm_stats={"n_workers": 2, "tasks": 5, "retries": 1,
                                    "worker_busy_s": [0.5, 0.25],
                                    "worker_tasks": [3, 2],
                                    "emitter_busy_s": 0.1})
    for needle in ("superstep", "w0.queued_weight", "farm_events_total",
                   "engine_queue_wait_ticks", "p50"):
        assert needle in txt


# -------------------------------------------------- the traced build

CASES = [(11, 240, dict(max_depth=5)),
         (3, 400, dict(max_nodes=4096, frontier_slots=8)),
         (7, 300, dict(max_nodes=4096, frontier_slots=32,
                       cost_model="nlogn"))]


def _snap(reg, names):
    snap = reg.snapshot()
    return {n: snap[n] for n in names}


@pytest.mark.parametrize("seed,n,cfg_kw", CASES)
def test_traced_build_equals_untraced_and_jax(seed, n, cfg_kw):
    ds = make_tree_dataset(np.random.default_rng(seed), n=n)
    cfg = GrowConfig(**cfg_kw)
    plain = frontier.build(ds, cfg, device="cpu")
    tr, reg = Tracer(), Registry()
    traced, stats = frontier.build(ds, cfg, device="cpu", collect_stats=True,
                                   tracer=tr, metrics=reg)
    jtr, jreg = JaxTracer(), JaxRegistry()
    jtree, jstats = jfrontier.build(ds, JaxGrowConfig(**cfg_kw), impl="jnp",
                                    collect_stats=True, tracer=jtr,
                                    metrics=jreg)
    assert trees_equal(plain, traced)
    assert trees_equal(traced, jtree)
    assert len(stats) == len(jstats)
    assert [{k: row[k] for k in want} for row, want in zip(stats, jstats)] \
        == jstats

    n_steps = len(stats)
    summ = tr.span_summary()
    assert set(summ) >= set(jtr.span_summary()) >= set(SPANS)
    assert all(summ[s]["count"] == n_steps for s in SPANS)
    steps = [e["args"]["step"] for e in tr.events
             if e["ph"] == "X" and e["name"] == "superstep"]
    assert steps == list(range(n_steps))

    assert _snap(reg, GAUGES_AND_COUNTERS) == _snap(jreg,
                                                    GAUGES_AND_COUNTERS)
    assert reg.snapshot()["frontier_supersteps_total"]["series"][0][
        "value"] == n_steps
    assert "frontier_phase_seconds" not in reg.snapshot()
    assert set(reg.snapshot()) == set(jreg.snapshot()) - {
        "frontier_phase_seconds"}

    def n_active(t):
        return [v for _, v in t.counter_series()["frontier.n_active"]]
    assert n_active(tr) == n_active(jtr)
    assert [v["value"] for v in n_active(tr)] == [r["n_active"]
                                                  for r in stats]


def test_traced_build_without_stats_returns_the_tree():
    ds = make_tree_dataset(np.random.default_rng(4), n=200)
    cfg = GrowConfig(max_depth=4)
    tr, reg = Tracer(), Registry()
    tree = frontier.build(ds, cfg, device="cpu", tracer=tr, metrics=reg)
    assert trees_equal(tree, frontier.build(ds, cfg, device="cpu"))
    n_steps = tr.span_summary()["superstep"]["count"]
    assert reg.snapshot()["frontier_supersteps_total"]["series"][0][
        "value"] == n_steps


def test_collect_stats_alone_feeds_the_registry():
    ds = make_tree_dataset(np.random.default_rng(9), n=260)
    cfg = GrowConfig(max_nodes=2048, frontier_slots=16)
    reg, jreg = Registry(), JaxRegistry()
    n0 = len(NULL.events)
    _, stats = frontier.build(ds, cfg, device="cpu", collect_stats=True,
                              metrics=reg)
    jfrontier.build(ds, JaxGrowConfig(max_nodes=2048, frontier_slots=16),
                    impl="jnp", collect_stats=True, metrics=jreg)
    assert len(NULL.events) == n0
    assert _snap(reg, GAUGES_AND_COUNTERS) == _snap(jreg,
                                                    GAUGES_AND_COUNTERS)
    assert reg.snapshot()["frontier_supersteps_total"]["series"][0][
        "value"] == len(stats)
    assert "frontier_phase_seconds" not in reg.snapshot()


def test_untraced_build_feeds_no_registry():
    ds = make_tree_dataset(np.random.default_rng(9), n=200)
    reg = Registry()
    frontier.build(ds, GrowConfig(max_depth=4), device="cpu", metrics=reg)
    frontier.build(ds, GrowConfig(max_depth=4), device="cpu", tracer=NULL,
                   metrics=reg)
    assert reg.snapshot() == {}


def test_tracing_disabled_leaves_no_residue():
    ds = make_tree_dataset(np.random.default_rng(2), n=200)
    cfg = GrowConfig(max_depth=4)
    n0 = len(NULL.events)
    a = frontier.build(ds, cfg, device="cpu")
    b = frontier.build(ds, cfg, device="cpu", tracer=NULL)
    assert trees_equal(a, b)
    assert len(NULL.events) == n0


# -------------------------------------------------- the traced build's spans

# each span's parent: the spans of ``PARENTS`` at the build's top level
PARENTS = {"splitPre": ("superstep",), "splitAtt": ("superstep",),
           "splitPost": ("superstep",), "wait.frontier": ("splitPre",),
           "compact": ("splitAtt",), "wait.compact": ("compact",),
           "kernel.histogram": ("splitAtt",),
           "kernel.split_gain": ("splitAtt",),
           "wait.status": ("splitPost", "entry.init"),
           "wait.loop": ("superstep", "entry.init")}
TOP = ("entry.copy", "entry.init", "superstep", "wait.stats")
IN_SUPERSTEP = ("splitPre", "splitAtt", "splitPost", "wait.frontier",
                "compact", "wait.compact", "kernel.histogram",
                "kernel.split_gain",
                "wait.status", "wait.loop")


def _inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


@pytest.mark.parametrize("seed,n,cfg_kw", CASES)
def test_traced_build_span_tree(seed, n, cfg_kw):
    ds = make_tree_dataset(np.random.default_rng(seed), n=n)
    tr = Tracer()
    _, stats = frontier.build(ds, GrowConfig(**cfg_kw), device="cpu",
                              collect_stats=True, tracer=tr,
                              metrics=Registry())
    n_steps = len(stats)
    spans = [e for e in tr.events if e["ph"] == "X"]
    by_name: dict[str, list[dict]] = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    assert set(by_name) == set(TOP) | set(PARENTS)
    for name in ("entry.copy", "entry.init", "wait.stats"):
        assert len(by_name[name]) == 1, name
    assert len(by_name["superstep"]) == n_steps
    assert len(by_name["wait.loop"]) == n_steps + 1
    assert len(by_name["wait.status"]) == n_steps + 1

    # every span inside its parent, on the same thread; the top level in
    # none of the others
    for e in spans:
        if e["name"] in PARENTS:
            assert sum(_inside(e, p) for name in PARENTS[e["name"]]
                       for p in by_name[name]) == 1, e
        else:
            assert not any(_inside(e, p) for p in spans if p is not e), e
    (init,) = by_name["entry.init"]
    for name in ("wait.status", "wait.loop"):
        assert sum(_inside(e, init) for e in by_name[name]) == 1, name
    assert by_name["entry.copy"][0]["ts"] < init["ts"]
    assert by_name["wait.stats"][0]["ts"] > max(
        e["ts"] + e["dur"] for e in by_name["superstep"])

    # a superstep: one of each, the loop's test after splitPost
    for step in by_name["superstep"]:
        held = {name: [e for e in by_name[name] if _inside(e, step)]
                for name in IN_SUPERSTEP}
        assert all(len(v) == 1 for v in held.values()), (step, held)
        post = held["splitPost"][0]
        assert held["wait.loop"][0]["ts"] >= post["ts"] + post["dur"]

    # the counter samples: a superstep's n_active at its start
    samples = tr.counter_series()["frontier.n_active"]
    assert [ts for ts, _ in samples] == [e["ts"]
                                         for e in by_name["superstep"]]
    assert [v["value"] for _, v in samples] == [r["n_active"]
                                                for r in stats]


@pytest.mark.parametrize("collect_stats", [False, True])
def test_traced_build_reads_the_statistics_once(monkeypatch, collect_stats):
    """Under a Tracer no superstep reads its statistics (no ``.item()``);
    one read after the loop gives the rows the untraced build reads a
    superstep at a time, value for value and type for type."""
    ds = make_tree_dataset(np.random.default_rng(5), n=300)
    cfg = GrowConfig(max_nodes=4096, frontier_slots=8)
    _, want = frontier.build(ds, cfg, device="cpu", collect_stats=True,
                             metrics=Registry())
    calls = {"item": 0, "read": 0}
    item, read = torch.Tensor.item, frontier._read_stats

    def counted_item(self):
        calls["item"] += 1
        return item(self)

    def counted_read(pending):
        calls["read"] += 1
        return read(pending)
    monkeypatch.setattr(torch.Tensor, "item", counted_item)
    monkeypatch.setattr(frontier, "_read_stats", counted_read)
    out = frontier.build(ds, cfg, device="cpu", collect_stats=collect_stats,
                         tracer=Tracer(), metrics=Registry())
    assert calls == {"item": 0, "read": 1}
    if collect_stats:
        rows = out[1]
        assert rows == want
        assert [[type(v) for v in r.values()] for r in rows] == [
            [type(v) for v in r.values()] for r in want]


def test_untraced_build_reads_the_statistics_each_superstep(monkeypatch):
    """Without a Tracer ``collect_stats`` reads a superstep's statistics
    after it, as before: ``.item()`` a value, no deferred read."""
    ds = make_tree_dataset(np.random.default_rng(5), n=300)
    cfg = GrowConfig(max_nodes=4096, frontier_slots=8)
    calls = {"item": 0}
    item = torch.Tensor.item

    def counted_item(self):
        calls["item"] += 1
        return item(self)
    monkeypatch.setattr(torch.Tensor, "item", counted_item)
    monkeypatch.setattr(frontier, "_read_stats", None)
    _, rows = frontier.build(ds, cfg, device="cpu", collect_stats=True,
                             metrics=Registry())
    assert calls["item"] == sum(len(r) for r in rows) > 0


def test_counter_sample_takes_a_span_start():
    tr = Tracer()
    with tr.span("outer") as span:
        tr.counter("c", value=1)
    tr.counter("c", ts=span.ts, value=2)
    (outer,) = [e for e in tr.events if e["ph"] == "X"]
    assert span.ts == outer["ts"]
    samples = tr.counter_series()["c"]
    assert samples[0] == (outer["ts"], {"value": 2})
    assert samples[1][1] == {"value": 1} and samples[1][0] > outer["ts"]
    NULL.counter("c", ts=0.0, value=3)
    assert "c" not in NULL.counter_series()
