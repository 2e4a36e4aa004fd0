"""The ``pokerhand10m`` configuration at small sizes on the CPU: its frozen
generator repeats for a seed, a small copy of its cell runs through the
harness and comes out correct, the bfloat16 control does not, and the
metric it brings, ``split_post_kernels_ms``, reads nothing where a run
holds nothing for it."""

import pytest
import torch

from bench import harness, reference, spec, trace
from bench.tests import _small

SEEDS = (7, 2**31 + 123)


@pytest.mark.parametrize("seed", SEEDS)
def test_repeats_for_a_seed(seed):
    _, a = _small.data("pokerhand10m", 5000, seed)
    _, b = _small.data("pokerhand10m", 5000, seed)
    _, c = _small.data("pokerhand10m", 5000, seed + 1)
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert a.n_bins == b.n_bins == [4, 13] * 5
    assert not torch.equal(a.x, c.x)
    assert a.x.shape == (5000, 10) and a.n_classes == 10
    assert a.attr_is_cont == [False, True] * 5
    assert set(a.y.unique().tolist()) >= {0, 1, 2, 3}


@pytest.fixture(scope="module")
def traced():
    s = spec.Spec.load()
    cell = s.cell("pokerhand10m.deep")
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
    # the CPU run has spans and no device trace: the device metrics read
    # nothing, whatever span metrics the cell lists
    m = harness.metrics(s, out["run"], trace_on=True)
    assert "split_post_kernels_ms" not in m
    assert ({x.name for x in s.metrics_of(cell.name, trace=True)}
            >= {"split_post_kernels_ms"})
    assert ({x.name for x in s.metrics_of(cell.name, trace=False)}
            >= {"build_s", "peak_mem_gib", "setup_s"})


@pytest.mark.parametrize("seed", (11, 2**31 + 13))
def test_control_fails_and_the_port_passes(seed):
    cfg, d = _small.data("pokerhand10m", 20000, seed)
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


def test_split_post_kernels_read_none_without_a_device_trace(traced):
    post = spec.reader("split_post_kernels_ms")
    assert post.read(_run(traced)) is None
    assert post.read(_run(traced, spans={"tree": [(0, 1)]},
                          span_trees=1)) is None
    # a trace without either kernel
    other = trace.DeviceTrace(window_s=1.0, busy_s=0.5, op_s={
        "frontier_histogram_kernel(int const*)": 1e-3}, idle_s={})
    assert post.read(_run(traced, device=other, device_trees=1)) is None


def test_split_post_kernels_sum_both_kernels_a_tree(traced):
    post = spec.reader("split_post_kernels_ms")
    run = _run(traced, device=trace.DeviceTrace(
        window_s=1.0, busy_s=0.5, op_s={
            "split_post_nodes_kernel(NodeArgs)": 2e-3,
            "split_post_route_kernel(int*, int const*, int4 const*)": 6e-3,
            "split_gain_kernel(float const*, long, long)": 5.0,
            "frontier_histogram_kernel(int const*)": 5.0}, idle_s={}),
        device_trees=4)
    assert post.read(run) == pytest.approx(8e-3 / 4 * 1e3, rel=1e-12)
