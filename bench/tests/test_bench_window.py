"""The window on the CPU: a traced run reads its spans from the trees the
Tracer alone traced, and every run also checks a tree grown on inputs
drawn from its own seed."""

from bench import harness, spec
from bench.tests import _small

CELL = "syd10m9a.deep"


def _run(trace_on, build=None):
    s = spec.Spec.load()
    cell = s.cell(CELL)
    cfg = _small.config(cell.config, 4000)
    out = harness.run_cell(cell, seed=2**31 + 7, seconds=0.0,
                           trace_on=trace_on, device="cpu", config=cfg,
                           build=build, log=lambda *_: None)
    return s, cell, out


def test_traced_run_reads_the_tracer_alone_trees():
    s, cell, out = _run(True)
    run = out["run"]
    assert out["correct"]
    # no card: no profiled part, every tree's spans are read
    assert run.span_trees == run.n_trees >= 1 and run.device is None
    m = harness.metrics(s, run, trace_on=True)
    for name in ("entry_ms", "split_pre_ms", "split_att_ms",
                 "split_post_ms", "build_mfu"):
        assert m[name]["value"] > 0
    assert "histogram_roofline" not in m and "device_idle" not in m


def test_the_seeds_own_inputs_are_checked():
    _, _, out = _run(False)
    assert out["attempted"] == out["run"].n_trees + 1
    assert out["compared"]["mismatched_nodes_seed_data"]["value"] == 0


def test_a_fault_on_the_seeds_inputs_alone_is_not_correct():
    """A build right on the window's inputs and wrong on any other."""
    cfg = _small.config("syd10m9a", 4000)
    plain = harness.port_builder(cfg["grow"], "cpu")
    # the window's cases in any order have this sum, the seed's others
    window_sum = harness.dataset(spec.generator("quest").generate(
        cfg, cfg["data_seed"], "cpu")).x.sum()

    def build(ds, tracer=None):
        tree = plain(ds)
        if ds.x.sum() != window_sum:
            tree.node_class[0] = 1 - tree.node_class[0]
        return tree
    _, _, out = _run(False, build)
    assert not out["correct"] and out["failed"] == 1
    assert out["compared"]["mismatched_nodes"]["value"] == 0
    assert out["compared"]["mismatched_nodes_seed_data"]["value"] > 0
