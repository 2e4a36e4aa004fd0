"""The program's spans on the CPU: a traced run reads the build's entry,
its host waits and its kernel calls from the trees the Tracer alone
traced, each span inside its tree on the Unix clock the harness puts
every span on."""

import pytest

from bench import harness, spec
from bench.tests import _small

NEW = ("entry_copy_ms", "entry_init_ms", "host_wait_ms",
       "host_waits_a_superstep", "kernel_call_ms")
SPANS = ("entry.copy", "entry.init", "wait.loop", "wait.frontier",
         "wait.compact", "wait.status", "wait.stats", "kernel.histogram",
         "kernel.split_gain")


@pytest.fixture(scope="module", params=["syd10m9a.deep", "syd10m9a.shallow"])
def traced(request):
    s = spec.Spec.load()
    cell = s.cell(request.param)
    cfg = _small.config(cell.config, 4000)
    out = harness.run_cell(cell, seed=2**31 + 11, seconds=0.0,
                           trace_on=True, device="cpu", config=cfg,
                           log=lambda *_: None)
    run = out["run"]
    return out, run, harness.metrics(s, run, trace_on=True)


def test_traced_run_reports_the_new_metrics(traced):
    out, run, m = traced
    assert out["correct"]
    for name in NEW:
        assert m[name]["value"] > 0, name
    assert m["host_waits_a_superstep"]["unit"] == "count"


def test_host_waits_a_superstep_is_four_and_three_over_n(traced):
    """Each superstep waits four times (the frontier's and the
    compaction's ``nonzero``, the new children's status write, the loop's
    test); a build three times more (the root's status write, the loop's
    first test, the statistics' read)."""
    _, run, m = traced
    n = len(run.spans["superstep"]) / run.span_trees
    assert n == int(n) >= 1
    assert m["host_waits_a_superstep"]["value"] == pytest.approx(
        (4 * n + 3) / n, rel=1e-12)


def test_entry_parts_lie_within_the_entry(traced):
    _, _, m = traced
    assert (m["entry_copy_ms"]["value"] + m["entry_init_ms"]["value"]
            <= m["entry_ms"]["value"])


def test_every_new_span_lies_in_its_tree(traced):
    _, run, _ = traced
    trees = sorted(run.spans["tree"])
    assert len(trees) == run.span_trees
    for name in SPANS:
        assert run.spans[name], name
        for s, e in run.spans[name]:
            assert any(ts <= s and e <= te for ts, te in trees), (name, s, e)
