"""The ``waveform40`` configuration at small sizes on the CPU: its frozen
generator repeats for a seed, a small copy of its cell runs through the
harness and comes out correct, the bfloat16 control does not, and the two
metrics it brings read nothing where a run holds nothing for them."""

import pytest
import torch

from bench import harness, reference, spec, trace
from bench.tests import _small

SEEDS = (7, 2**31 + 123)


@pytest.mark.parametrize("seed", SEEDS)
def test_repeats_for_a_seed(seed):
    _, a = _small.data("waveform40", 5000, seed)
    _, b = _small.data("waveform40", 5000, seed)
    _, c = _small.data("waveform40", 5000, seed + 1)
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert a.n_bins == b.n_bins
    assert not torch.equal(a.x, c.x)
    assert a.x.shape == (5000, 40) and a.n_classes == 3
    assert all(a.attr_is_cont) and max(a.n_bins) == 256
    assert set(a.y.unique().tolist()) == {0, 1, 2}


@pytest.fixture(scope="module")
def traced():
    s = spec.Spec.load()
    cell = s.cell("waveform40.deep")
    cfg = _small.config(cell.config, 4000)
    out = harness.run_cell(cell, seed=2**31 + 17, seconds=0.0,
                           trace_on=True, device="cpu", config=cfg,
                           log=lambda *_: None)
    return s, cell, out


def test_small_cell_is_correct(traced):
    s, cell, out = traced
    assert out["correct"] and out["failed"] == 0
    assert out["compared"]["mismatched_nodes"]["value"] == 0
    assert out["compared"]["mismatched_nodes_seed_data"]["value"] == 0
    m = harness.metrics(s, out["run"], trace_on=True)
    # the CPU run has spans and no device trace
    assert m["compact_ms"]["value"] > 0
    assert "split_gain_smem_roofline" not in m
    assert ({x.name for x in s.metrics_of(cell.name, trace=True)}
            == {"compact_ms", "split_gain_smem_roofline"})


@pytest.mark.parametrize("seed", (11, 2**31 + 13))
def test_control_fails_and_the_port_passes(seed):
    cfg, d = _small.data("waveform40", 20000, seed)
    grow = cfg["grow"]
    control = _small.oracle(d, grow, dtype=torch.bfloat16).tree
    judged = _small.oracle(d, grow, tested=control)
    assert reference.compare(control, judged.tree) > 0
    port = _small.port_tree(d, grow)
    judged = _small.oracle(d, grow, tested=port)
    assert reference.compare(port, judged.tree) == 0


def _run(traced, **kw) -> harness.Run:
    """A run with the small cell's work and ``kw``'s spans or trace."""
    base = traced[2]["run"]
    return harness.Run(cell=base.cell, setup_s=1.0, window_s=1.0,
                       tree_s=[1.0], peak_bytes=0, work=base.work, **kw)


def test_metrics_read_none_without_spans_or_a_device_trace(traced):
    compact = spec.reader("compact_ms")
    smem = spec.reader("split_gain_smem_roofline")
    assert compact.read(_run(traced)) is None
    assert compact.read(_run(traced, spans={"tree": [(0, 1)]},
                             span_trees=1)) is None
    assert smem.read(_run(traced)) is None
    # a trace with the register kernel alone: no shared-memory launch
    regs = trace.DeviceTrace(window_s=1.0, busy_s=0.5, op_s={
        "void split_gain_regs_kernel<2, 8>(float const*)": 1e-3}, idle_s={})
    assert smem.read(_run(traced, device=regs, device_trees=1)) is None


def test_smem_roofline_reads_the_shared_memory_kernel_alone(traced):
    smem = spec.reader("split_gain_smem_roofline")
    run = _run(traced, device=trace.DeviceTrace(
        window_s=1.0, busy_s=0.5, op_s={
            "split_gain_kernel(float const*, long, long)": 2e-3,
            "void split_gain_regs_kernel<2, 8>(float const*)": 5.0,
            "frontier_histogram_kernel(int const*)": 5.0}, idle_s={}),
        device_trees=2)
    want = 100 * run.work.split_gain_s() * 2 / 2e-3
    assert smem.read(run) == pytest.approx(want, rel=1e-12)
    assert 0 < smem.read(run) < 100
