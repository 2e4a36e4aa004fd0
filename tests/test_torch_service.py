"""The torch predict service (repro_torch.infer.service) against the JAX one.

Each scenario of tests/test_infer_service.py runs through both services on
the CPU with the same trees, requests, policy and fault schedule.  Both must
end with identical result records (uid, label, replica, batch size, arm),
identical failure records, identical ``stats()``, identical metric
snapshots and the same sequence of trace events (names, phases and
arguments; timestamps and thread names aside).  Labels are exact.
"""

import types

import numpy as np
import pytest
from conftest import make_tree_dataset, run_with_timeout

from repro.core import c45
from repro.core.config import GrowConfig as JaxGrowConfig
from repro.infer import forest as JF
from repro.infer import registry as jreg
from repro.infer import service as jsvc
from repro.obs import metrics as jmetrics
from repro.obs import trace as jtrace
from repro_torch.core.tree import FIELDS as TREE_FIELDS
from repro_torch.core.tree import tree_from_numpy
from repro_torch.infer import forest as F
from repro_torch.infer import registry as reg
from repro_torch.infer import service as svc
from repro_torch.obs import metrics
from repro_torch.obs import trace


def _flaky(base):
    class FlakyReplica(base):
        """Dies (tick raises) after serving ``fail_after`` batches."""

        def __init__(self, *a, fail_after=1, **kw):
            super().__init__(*a, **kw)
            self.fail_after = fail_after
            self.served = 0

        def tick(self):
            if self.queue and self.served >= self.fail_after:
                raise RuntimeError("injected replica death")
            out = super().tick()
            if out[0]:
                self.served += 1
            return out
    return FlakyReplica


def _carry(jtree):
    t = jtree.to_numpy()
    return tree_from_numpy({f: getattr(t, f) for f in TREE_FIELDS}, "cpu")


JAX = types.SimpleNamespace(
    name="jax", svc=jsvc, registry=jreg, Registry=jmetrics.Registry,
    Tracer=jtrace.Tracer, Flaky=_flaky(jsvc.InferReplica),
    pack=lambda trees: JF.Forest.pack(trees),
    tree=lambda t: t, handle=lambda root: jreg.ModelHandle(root, "m"))
PORT = types.SimpleNamespace(
    name="port", svc=svc, registry=reg, Registry=metrics.Registry,
    Tracer=trace.Tracer, Flaky=_flaky(svc.InferReplica),
    pack=lambda trees: F.Forest.pack([_carry(t) for t in trees],
                                     device="cpu"),
    tree=_carry, handle=lambda root: reg.ModelHandle(root, "m",
                                                     device="cpu"))


@pytest.fixture(scope="module")
def ds():
    return make_tree_dataset(np.random.default_rng(0), n=300,
                             unknown_frac=0.1)


@pytest.fixture(scope="module")
def trees(ds):
    """A full tree and a deliberately degenerate depth-1 stump (so canary
    and stable arms disagree)."""
    return (c45.build(ds, JaxGrowConfig()),
            c45.build(ds, JaxGrowConfig(max_depth=1)))


def _replicas(pkg, fo, cont, spec):
    """``spec``: one entry per replica, None for a healthy one, else the
    number of batches it serves before it dies."""
    out = []
    for fail_after in spec:
        rep = pkg.svc.InferReplica.from_forest(fo, cont)
        out.append(rep if fail_after is None else
                   pkg.Flaky(rep.models, fail_after=fail_after))
    return out


def _submit(service, pkg, ds, n, start=0):
    for u in range(start, start + n):
        service.submit(pkg.svc.PredictRequest(uid=u,
                                              x_row=ds.x[u % ds.n_cases]))


def _records(service, reg_, tracer):
    # thread-name metadata ("M") names the thread that ran the drain
    events = [(e.get("name"), e.get("ph"), e.get("id"),
               tuple(sorted((e.get("args") or {}).items())))
              for e in tracer.events if e.get("ph") != "M"]
    return dict(
        results=[(r.uid, r.label, r.replica, r.batch_size, r.arm)
                 for r in service.results],
        failed=[(f.uid, f.reason, f.detail) for f in service.failed],
        stats=service.stats(), metrics=reg_.snapshot(), events=events)


def _serve(pkg, ds, trees, tmp_path, *, replicas=(None,), n=64,
           canary=None, shadow=False, trace_on=False, **kw):
    """Run one scenario through ``pkg``'s service; returns its records."""
    reg_ = pkg.Registry()
    tracer = pkg.Tracer(enabled=trace_on)
    if canary is None:
        handle = None
        reps = _replicas(pkg, pkg.pack([trees[0]]), ds.attr_is_cont,
                         replicas)
    else:
        root = str(tmp_path / pkg.name)
        cand = pkg.registry.publish(root, "m", pkg.tree(trees[0]))
        pkg.registry.publish(root, "m", pkg.tree(trees[1]))
        handle = pkg.handle(root)
        handle.set_canary(cand, canary, shadow=shadow)
        reps = [pkg.svc.InferReplica.from_handle(handle, ds.attr_is_cont)
                for _ in replicas]
    service = pkg.svc.BatchPredictService(reps, handle=handle, metrics=reg_,
                                          tracer=tracer, **kw)
    _submit(service, pkg, ds, n)
    run_with_timeout(service.run_until_drained)
    return _records(service, reg_, tracer)


def _expected(ds, trees, uids, tree=0):
    labels = np.asarray(JF.predict(JF.Forest.pack([trees[tree]]), ds.x,
                                   ds.attr_is_cont))
    return {u: int(labels[u % ds.n_cases]) for u in uids}


SCENARIOS = {
    "full_batches": dict(n=64, max_batch=32, max_wait_ticks=50),
    "stragglers": dict(n=10, max_batch=64, max_wait_ticks=3),
    "three_replicas": dict(n=100, replicas=(None,) * 3, max_batch=16,
                           max_wait_ticks=2),
    "ws_spreads": dict(n=160, replicas=(None,) * 4, policy="ws",
                       max_batch=8, max_wait_ticks=1),
    "policy_ws": dict(n=60, replicas=(None,) * 3, policy="ws", max_batch=8,
                      max_wait_ticks=2),
    "policy_drr": dict(n=60, replicas=(None,) * 3, policy="drr",
                       max_batch=8, max_wait_ticks=2),
    "policy_od": dict(n=60, replicas=(None,) * 3, policy="od", max_batch=8,
                      max_wait_ticks=2),
    "policy_health_ws": dict(n=60, replicas=(None,) * 3, policy="health_ws",
                             max_batch=8, max_wait_ticks=2),
    "replica_death": dict(n=80, replicas=(1, None), max_batch=8,
                          max_wait_ticks=1),
    "all_replicas_dead": dict(n=20, replicas=(0,), max_batch=8,
                              max_wait_ticks=1),
    "requeue_budget": dict(n=12, replicas=(0, 0), max_batch=4,
                           max_wait_ticks=1, max_requeues=1),
    "eviction_masks_indices": dict(n=40, replicas=(0, None, None),
                                   policy="drr", max_batch=4,
                                   max_wait_ticks=1),
    "accounting": dict(n=120, replicas=(2, None), max_batch=8,
                       max_wait_ticks=1),
    "canary": dict(n=120, canary=0.5, max_batch=8, max_wait_ticks=1),
    "shadow": dict(n=64, canary=0.5, shadow=True, max_batch=16,
                   max_wait_ticks=1),
    "traced": dict(n=40, replicas=(None, None), max_batch=8,
                   max_wait_ticks=2, trace_on=True),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_records_equal_jax(ds, trees, tmp_path, name):
    kw = SCENARIOS[name]
    got = _serve(PORT, ds, trees, tmp_path, **kw)
    want = _serve(JAX, ds, trees, tmp_path, **kw)
    for key in ("results", "failed", "stats", "metrics", "events"):
        assert got[key] == want[key], key
    # and the records are what the scenario promises
    n = kw["n"]
    assert len(got["results"]) + len(got["failed"]) == n
    if kw.get("canary") is None:
        want_labels = _expected(ds, trees, range(n))
        assert all(lab == want_labels[u] for u, lab, *_ in got["results"])
    if name in ("all_replicas_dead", "requeue_budget"):
        assert not got["results"] and got["stats"]["healthy_replicas"] == 0
    elif name == "ws_spreads":
        assert {r[2] for r in got["results"]} == {0, 1, 2, 3}
    elif name == "canary":
        arms = {r[4] for r in got["results"]}
        assert arms == {"stable", "canary"}
    elif name == "shadow":
        assert got["metrics"]["infer_shadow_mirrored_total"]
    elif name not in ("accounting", "eviction_masks_indices"):
        assert len(got["results"]) == n


def test_hot_swap_reaches_replicas_as_in_jax(ds, trees, tmp_path):
    """promote_canary on the handle reaches a running replica's next batch
    in both services alike."""
    out = {}
    for pkg in (PORT, JAX):
        root = str(tmp_path / pkg.name)
        cand = pkg.registry.publish(root, "m", pkg.tree(trees[0]))
        pkg.registry.publish(root, "m", pkg.tree(trees[1]))
        handle = pkg.handle(root)
        rep = pkg.svc.InferReplica.from_handle(handle, ds.attr_is_cont)
        runs = []
        for swap in (False, True):
            if swap:
                handle.set_canary(cand, 0.0)
                handle.promote_canary()
            service = pkg.svc.BatchPredictService(
                [rep], handle=handle, max_batch=8, max_wait_ticks=1,
                metrics=pkg.Registry())
            _submit(service, pkg, ds, 16)
            run_with_timeout(service.run_until_drained)
            runs.append([(r.uid, r.label) for r in service.results])
        out[pkg.name] = runs
    assert out["port"] == out["jax"]
    want = _expected(ds, trees, range(16))
    assert all(lab == want[u] for u, lab in out["port"][1])


def test_max_ticks_fails_the_rest_explicitly():
    """A drain cut at max_ticks ends every request, in both services."""
    rng = np.random.default_rng(5)
    ds = make_tree_dataset(rng, n=100)
    tree = c45.build(ds, JaxGrowConfig())
    out = {}
    for pkg in (PORT, JAX):
        service = pkg.svc.BatchPredictService(
            [pkg.svc.InferReplica.from_forest(pkg.pack([tree]),
                                              ds.attr_is_cont)],
            max_batch=4, max_wait_ticks=1, metrics=pkg.Registry())
        _submit(service, pkg, ds, 40)
        service.run_until_drained(max_ticks=3)
        out[pkg.name] = (len(service.results),
                         [(f.uid, f.reason) for f in service.failed],
                         service.stats())
    assert out["port"] == out["jax"]
    assert out["port"][0] + len(out["port"][1]) == 40
    assert {r for _, r in out["port"][1]} == {"max_ticks"}


def test_replica_rejects_unknown_arm(ds, trees):
    rep = svc.InferReplica.from_forest(PORT.pack([trees[0]]),
                                       ds.attr_is_cont)
    with pytest.raises(KeyError):
        rep.admit(svc._Batch(arm="canary", requests=[
            svc.PredictRequest(uid=0, x_row=ds.x[0])]))


def test_labels_come_back_as_numpy(ds, trees):
    rep = svc.InferReplica.from_forest(PORT.pack([trees[0]]),
                                       ds.attr_is_cont)
    labels = rep.models["stable"](ds.x[:7])
    assert isinstance(labels, np.ndarray) and labels.shape == (7,)
    np.testing.assert_array_equal(
        labels, np.asarray(JF.predict(JF.Forest.pack([trees[0]]),
                                      ds.x[:7], ds.attr_is_cont)))
