"""A run with the timed path broken underneath comes out as not correct,
for each fault a tree build can have: a build that returns its state
unchanged, half of the cases left out, and an answer altered where it is
produced.  The harness runs on the CPU here, the look for a card skipped,
with the port's plain path in place of the card's."""

import pytest

from bench import harness, spec
from bench.tests import _small

CELL = "syd10m9a.deep"


def _run(build_wrapper):
    cell = spec.Spec.load().cell(CELL)
    cfg = _small.config(cell.config, 4000)
    plain = harness.port_builder(cfg["grow"], "cpu")
    # the same build with no superstep changing its state: the root alone
    still = harness.port_builder({**cfg["grow"], "max_depth": 0}, "cpu")

    def build(ds, tracer=None):
        return build_wrapper(plain, ds, still)
    return harness.run_cell(cell, seed=2**31 + 99, seconds=0.0,
                            trace_on=False, device="cpu", config=cfg,
                            build=build, log=lambda *_: None)


def _unchanged(plain, ds, still):
    return still(ds)


def _half(plain, ds, still):
    return plain(ds.subset(slice(0, ds.n_cases // 2)))


def _altered(plain, ds, still):
    tree = plain(ds)
    leaf = int((tree.node_attr[:int(tree.n_nodes)] < 0).nonzero()[-1])
    tree.node_class[leaf] = 1 - tree.node_class[leaf]
    return tree


def test_sound_run_is_correct():
    out = _run(lambda plain, ds, still: plain(ds))
    assert out["correct"] and out["failed"] == 0
    assert out["compared"]["mismatched_nodes"]["value"] == 0


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
def test_fault_is_not_correct(fault):
    out = _run(fault)
    assert not out["correct"]
    assert out["failed"] == out["attempted"] >= 1
    assert out["compared"]["mismatched_nodes"]["value"] > 0
