"""The port's farm build against the JAX oracle, under injected chaos.

Every case of ``tests/test_farm_build_chaos.py`` runs through
``repro_torch.core.farm_build`` (``device="cpu"``): the seeded
:class:`~repro_torch.core.faults.FaultInjector` crashes task attempts at
p=0.2 and kills one worker permanently; the supervised farm must retry /
re-dispatch until the full C4.5 tree is grown, ``trees_equal`` to the JAX
package's sequential oracle ``repro.core.c45.build`` (structure exact,
``node_freq`` within atol 1e-3), without ever deadlocking
(``run_with_timeout`` turns a hang into a failure).  Only injected faults
may count as failures: the crashes in the injector's log plus the one
attempt each dead worker takes down.
"""

import functools

import numpy as np
import pytest
import torch

from conftest import make_tree_dataset, run_with_timeout
from repro.core import c45 as jc45
from repro.core.config import GrowConfig as JaxGrowConfig
from repro.core.tree import predict as jax_predict
from repro_torch.core import c45, faults, frontier
from repro_torch.core.config import GrowConfig
from repro_torch.core.farm import FaultPolicy
from repro_torch.core.farm_build import QuarantinedNodes, build
from repro_torch.core.tree import predict, trees_equal

pytestmark = pytest.mark.timeout(300)

CFG = dict(max_nodes=1 << 13)


def _dataset(seed=0, n=400, **kw):
    rng = np.random.default_rng(seed)
    kw.setdefault("n_cont", 2)
    kw.setdefault("n_disc", 2)
    kw.setdefault("n_classes", 3)
    return make_tree_dataset(rng, n, **kw)


@functools.lru_cache(maxsize=None)
def _oracle(seed=0, n=400, unknown_frac=0.0, fractional=False):
    """The JAX oracle's tree of ``_dataset(seed, n, ...)``."""
    ds = _dataset(seed, n, unknown_frac=unknown_frac)
    return jc45.build(ds, JaxGrowConfig(**CFG,
                                        unknown_fractional=fractional))


def _farm(ds, cfg=GrowConfig(**CFG), **kw):
    return build(ds, cfg, device="cpu", **kw)


def test_farm_build_matches_oracle_without_faults():
    ds = _dataset()
    t_farm = run_with_timeout(lambda: _farm(ds, n_workers=4), 120)
    assert trees_equal(t_farm, _oracle())


def test_farm_build_handles_unknowns_and_fractional_weights():
    ds = _dataset(seed=3, unknown_frac=0.15)
    for fractional in (False, True):
        cfg = GrowConfig(**CFG, unknown_fractional=fractional)
        t_farm = run_with_timeout(lambda: _farm(ds, cfg, n_workers=3), 120)
        assert trees_equal(t_farm, _oracle(3, 400, 0.15, fractional))


def test_farm_build_oracle_equal_under_seeded_chaos():
    """crash_p=0.2 + one permanently dead worker -> identical tree."""
    ds = _dataset()
    inj = faults.FaultInjector(seed=7, spec=faults.FaultSpec(
        crash_p=0.2, slow_p=0.1, slow_s=0.002,
        dead_workers=frozenset({1})), key_fn=lambda t: t.node_id)
    stats = {}
    t_chaos = run_with_timeout(
        lambda: _farm(ds, n_workers=4,
                      fault=FaultPolicy(max_retries=8, seed=3,
                                        backoff_base=1e-4),
                      injector=inj, stats_out=stats), 240)
    t_seq = _oracle()
    assert trees_equal(t_chaos, t_seq), "chaos build diverged from oracle"
    p1 = predict(t_chaos, ds.x, ds.attr_is_cont).numpy()
    p2 = np.asarray(jax_predict(t_seq, ds.x, ds.attr_is_cont))
    assert (p1 == p2).all()
    assert stats["failures"] > 0 and stats["retries"] > 0
    assert stats["quarantined"] == 0
    assert stats["dead_workers"] == [1]
    crashes = sum(1 for _, _, action in inj.log if action == "crash")
    assert stats["failures"] == crashes + len(stats["dead_workers"])


def test_farm_build_chaos_is_replayable():
    """Same seed -> same fault schedule -> same farm stats."""
    ds = _dataset(seed=5, n=250)

    def run_once():
        inj = faults.FaultInjector(seed=11, spec=faults.FaultSpec(
            crash_p=0.25), key_fn=lambda t: t.node_id)
        stats = {}
        tree = _farm(ds, n_workers=3,
                     fault=FaultPolicy(max_retries=8, backoff_base=0.0),
                     injector=inj, stats_out=stats)
        return tree, stats["failures"], stats["retries"]

    t1, f1, r1 = run_with_timeout(run_once, 120)
    t2, f2, r2 = run_with_timeout(run_once, 120)
    assert trees_equal(t1, t2)
    assert (f1, r1) == (f2, r2)
    assert trees_equal(t1, c45.build(ds, GrowConfig(**CFG), device="cpu"))


def test_farm_build_quarantine_degrades_node_to_leaf():
    ds = _dataset(seed=9, n=200)
    inj = faults.FaultInjector(seed=0, spec=faults.FaultSpec(crash_p=1.0),
                               key_fn=lambda t: t.node_id)
    fault = FaultPolicy(max_retries=1, backoff_base=0.0)
    with pytest.raises(QuarantinedNodes):
        run_with_timeout(
            lambda: _farm(ds, n_workers=2, fault=fault, injector=inj), 120)
    # non-strict: the poisoned root degrades to a single-leaf tree
    tree = run_with_timeout(
        lambda: _farm(ds, n_workers=2, fault=fault,
                      injector=faults.FaultInjector(
                          seed=0, spec=faults.FaultSpec(crash_p=1.0),
                          key_fn=lambda t: t.node_id),
                      strict=False), 120)
    assert tree.size == 1
    assert predict(tree, ds.x, ds.attr_is_cont).shape == (200,)


def test_a_raising_split_is_retried_then_quarantined(monkeypatch):
    """A worker's own exception (a failed launch, say) is a task failure:
    retried, then quarantined, and strict=True raises."""
    ds = _dataset(seed=2, n=150)
    calls = []

    def failing(*args, **kw):
        calls.append(1)
        raise RuntimeError("launch failed: invalid argument")
    monkeypatch.setattr(c45, "split_node", failing)
    stats = {}
    with pytest.raises(QuarantinedNodes):
        run_with_timeout(lambda: _farm(
            ds, n_workers=2, fault=FaultPolicy(max_retries=2,
                                               backoff_base=0.0),
            stats_out=stats), 60)
    assert len(calls) == 3 and stats["failures"] == 3


def test_frontier_build_farm_entrypoint():
    ds = _dataset(seed=2, n=150)
    t_farm = run_with_timeout(
        lambda: frontier.build_farm(ds, GrowConfig(**CFG), n_workers=2,
                                    device="cpu"), 120)
    assert trees_equal(t_farm, jc45.build(ds, JaxGrowConfig(**CFG)))


def test_farm_build_hooks_match_oracle():
    """attr_mask / case_w reach the farm's tasks as they reach c45's."""
    from repro_torch.ensemble import sampling
    ds = _dataset(seed=8, n=200)
    s = sampling.draw(0, 0, n_cases=ds.n_cases, n_attrs=ds.n_attrs,
                      base_w=ds.w)
    want = jc45.build(ds, JaxGrowConfig(**CFG), attr_mask=s.attr_mask,
                      case_w=s.case_w)
    got = run_with_timeout(
        lambda: _farm(ds, n_workers=3, attr_mask=s.attr_mask,
                      case_w=s.case_w), 120)
    assert trees_equal(got, want)


def test_farm_build_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build(_dataset(n=64), GrowConfig(**CFG))


def test_yadt_workload_is_the_jax_packages():
    """The grow configuration every full-size run uses is the JAX
    package's YaDTWorkload, and get_config("yadt") names it."""
    import dataclasses

    from repro.configs import yadt as jyadt
    from repro_torch.configs import base, yadt
    assert base.get_config("yadt") is yadt.CONFIG
    assert yadt.CONFIG.family == "tree"
    assert "yadt" not in base.ARCH_IDS           # the LM launcher's list
    got = dataclasses.asdict(yadt.WORKLOAD)
    want = dataclasses.asdict(jyadt.WORKLOAD)
    for key in ("n_cases", "n_attrs", "n_bins", "n_classes",
                "max_children"):
        assert got[key] == want[key]
    for key, value in got["grow"].items():
        if key in want["grow"]:
            assert value == want["grow"][key], key
