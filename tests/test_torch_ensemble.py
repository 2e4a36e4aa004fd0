"""The port's ensemble trainer, OOB and publish against the JAX package's.

Every case of ``tests/test_ensemble.py`` runs through ``repro_torch``
(``device="cpu"``), and the port is held to the JAX package on the same
inputs:

  * ``train_forest_sequential(impl="c45")`` of both packages grow
    ``trees_equal`` forests (structure exact, ``node_freq`` within atol
    1e-3); the port's farm run, chaos included, and its
    ``impl="frontier"`` equal the port's sequential oracle;
  * ``oob_score``: ``pred`` exactly the JAX one's, ``score`` and
    ``coverage`` equal; ``permutation_importance`` within 1e-12 of it;
  * ``publish_forest``: the manifest (metadata, shapes, dtypes, crc32s)
    equals the JAX one's, and rows served through the port's
    ``BatchPredictService`` equal ``predict(impl="ref")``.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from conftest import make_tree_dataset, run_with_timeout
from repro.core.config import GrowConfig as JaxGrowConfig
from repro.ensemble import oob as joob
from repro.ensemble import publish as jpublish
from repro.ensemble import trainer as jtrainer
from repro_torch.core import faults
from repro_torch.core.config import GrowConfig
from repro_torch.core.farm import FaultPolicy
from repro_torch.core.tree import trees_equal
from repro_torch.ensemble import (ForestConfig, QuarantinedTrees, oob,
                                  publish, sampling, trainer)
from repro_torch.infer import forest as F
from repro_torch.infer import registry
from repro_torch.infer.service import (BatchPredictService, InferReplica,
                                       PredictRequest)
from repro_torch.obs.metrics import Registry

pytestmark = pytest.mark.timeout(300)

GROW_KW = dict(max_nodes=1 << 12)
GROW = GrowConfig(**GROW_KW)
CPU = dict(device="cpu")


def _dataset(seed=0, n=300, **kw):
    rng = np.random.default_rng(seed)
    kw.setdefault("n_cont", 2)
    kw.setdefault("n_disc", 2)
    kw.setdefault("n_classes", 3)
    return make_tree_dataset(rng, n, **kw)


def _forests_equal(a, b):
    return len(a) == len(b) and all(trees_equal(x, y) for x, y in zip(a, b))


def _jax_fc(fc: ForestConfig) -> jtrainer.ForestConfig:
    return jtrainer.ForestConfig(n_trees=fc.n_trees, seed=fc.seed,
                                 mtry=fc.mtry, bootstrap=fc.bootstrap,
                                 grow=JaxGrowConfig(**GROW_KW))


@functools.lru_cache(maxsize=None)
def _jax_forest(seed, n, n_trees, forest_seed):
    """The JAX package's sequential c45 forest (cached: a JAX c45 build
    is the slow part of this file)."""
    fc = ForestConfig(n_trees=n_trees, seed=forest_seed, grow=GROW)
    return jtrainer.train_forest_sequential(_dataset(seed, n), _jax_fc(fc))


# ------------------------------------------------------------------ sampling

class TestSampling:
    def test_pure_in_seed_and_tree_id(self):
        a = sampling.draw(3, 5, n_cases=100, n_attrs=7)
        b = sampling.draw(3, 5, n_cases=100, n_attrs=7)
        np.testing.assert_array_equal(a.counts, b.counts)
        np.testing.assert_array_equal(a.attr_mask, b.attr_mask)
        c = sampling.draw(3, 6, n_cases=100, n_attrs=7)
        assert not np.array_equal(a.counts, c.counts) \
            or not np.array_equal(a.attr_mask, c.attr_mask)

    def test_bootstrap_preserves_total_draws(self):
        counts = sampling.bootstrap_counts(0, 0, 500)
        assert counts.sum() == 500
        assert (counts == 0).any()          # ~36.8% of cases are OOB

    def test_feature_mask_size_and_bounds(self):
        m = sampling.feature_mask(0, 0, 9)
        assert m.sum() == sampling.default_mtry(9) == 3
        assert sampling.feature_mask(0, 0, 9, mtry=9).all()
        with pytest.raises(ValueError):
            sampling.feature_mask(0, 0, 9, mtry=10)
        with pytest.raises(ValueError):
            sampling.feature_mask(0, 0, 9, mtry=0)

    def test_no_bootstrap_keeps_base_weights(self):
        s = sampling.draw(0, 0, n_cases=10, n_attrs=3, bootstrap=False,
                          base_w=np.full(10, 2.0, np.float32))
        np.testing.assert_array_equal(s.case_w, np.full(10, 2.0))
        assert not s.oob.any()


# ------------------------------------------------------- farm determinism

class TestFarmDeterminism:
    def test_sequential_c45_forest_equals_jax(self):
        ds = _dataset()
        fc = ForestConfig(n_trees=5, seed=2, grow=GROW)
        seq = trainer.train_forest_sequential(ds, fc, **CPU)
        assert _forests_equal(seq, _jax_forest(0, 300, 5, 2))

    def test_forest_identical_across_worker_counts(self):
        ds = _dataset()
        fc = ForestConfig(n_trees=5, seed=2, grow=GROW)
        want = _jax_forest(0, 300, 5, 2)
        for n_workers in (1, 4):
            res = run_with_timeout(
                lambda: trainer.train_forest(ds, fc, n_workers=n_workers,
                                             **CPU), 120)
            assert res.tree_ids == list(range(5))
            assert _forests_equal(res.trees, want), \
                f"forest diverged at n_workers={n_workers}"

    def test_chaos_run_equals_oracle(self):
        """Acceptance: crash_p=0.2 + a permanently dead worker -> identical
        forest, with real retries exercised."""
        ds = _dataset()
        fc = ForestConfig(n_trees=8, seed=0, grow=GROW)
        inj = faults.FaultInjector(
            seed=7, spec=faults.FaultSpec(
                crash_p=0.2, dead_workers=frozenset({1})),
            key_fn=lambda tid: tid)
        stats = {}
        res = run_with_timeout(
            lambda: trainer.train_forest(
                ds, fc, n_workers=4, injector=inj,
                fault=FaultPolicy(max_retries=8, seed=3, backoff_base=1e-4),
                stats_out=stats, **CPU), 240)
        assert _forests_equal(res.trees, _jax_forest(0, 300, 8, 0)), \
            "chaos forest diverged from the sequential oracle"
        assert stats["dead_workers"] == [1]
        assert stats["failures"] > 0 and stats["retries"] > 0
        assert stats["quarantined"] == 0 and not res.quarantined
        crashes = sum(1 for _, _, action in inj.log if action == "crash")
        assert stats["failures"] == crashes + 1   # + the dead worker's try

    def test_frontier_impl_matches_c45(self):
        ds = _dataset(seed=4)
        fc = ForestConfig(n_trees=4, seed=5, grow=GROW)
        seq = trainer.train_forest_sequential(ds, fc, impl="c45", **CPU)
        fro = trainer.train_forest_sequential(ds, fc, impl="frontier", **CPU)
        assert _forests_equal(seq, fro)
        farm = run_with_timeout(lambda: trainer.train_forest(
            ds, fc, impl="frontier", n_workers=3, **CPU), 120)
        assert _forests_equal(farm.trees, seq)

    def test_feature_mask_actually_restricts_splits(self):
        ds = _dataset(seed=1)
        fc = ForestConfig(n_trees=4, seed=3, mtry=1, grow=GROW)
        trees = trainer.train_forest_sequential(ds, fc, impl="frontier",
                                                **CPU)
        for tid, tree in enumerate(trees):
            mask = sampling.feature_mask(fc.seed, tid, ds.n_attrs, 1)
            used = tree.to_numpy().node_attr[:tree.size]
            used = set(used[used >= 0].tolist())
            allowed = set(np.nonzero(mask)[0].tolist())
            assert used <= allowed, f"tree {tid} split outside its subset"

    def test_strict_quarantine_raises_nonstrict_drops(self):
        ds = _dataset(seed=6, n=150)
        fc = ForestConfig(n_trees=3, seed=1, grow=GROW)

        def poisoned():
            inj = faults.FaultInjector(
                seed=0, spec=faults.FaultSpec(crash_p=1.0),
                key_fn=lambda tid: "poison" if tid == 1 else f"ok{tid}")
            inj.decide = lambda key, call: \
                "crash" if key == "poison" else "ok"
            return inj
        fault = FaultPolicy(max_retries=1, backoff_base=0.0)
        with pytest.raises(QuarantinedTrees):
            run_with_timeout(
                lambda: trainer.train_forest(ds, fc, n_workers=2,
                                             injector=poisoned(),
                                             fault=fault, **CPU), 120)
        res = run_with_timeout(
            lambda: trainer.train_forest(ds, fc, n_workers=2,
                                         injector=poisoned(), fault=fault,
                                         strict=False, **CPU), 120)
        assert res.quarantined == [1]
        assert res.tree_ids == [0, 2]
        seq = trainer.train_forest_sequential(ds, fc, **CPU)
        assert trees_equal(res.trees[0], seq[0])
        assert trees_equal(res.trees[1], seq[2])

    def test_trainer_metrics_and_spans(self):
        from repro_torch.obs.trace import Tracer
        ds = _dataset(seed=2, n=150)
        fc = ForestConfig(n_trees=3, seed=0, grow=GROW)
        reg = Registry()
        tracer = Tracer()
        run_with_timeout(
            lambda: trainer.train_forest(ds, fc, n_workers=2, metrics=reg,
                                         tracer=tracer, **CPU), 120)
        assert reg.get("ensemble_trees_trained_total").value(impl="c45") == 3
        assert reg.get("ensemble_trees_per_s").value(impl="c45") > 0
        names = {e.get("name") for e in tracer.events}
        assert "ensemble.tree" in names

    def test_without_device_needs_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is valid")
        ds = _dataset(n=64)
        fc = ForestConfig(n_trees=1, grow=GROW)
        for call in (lambda: trainer.train_forest(ds, fc),
                     lambda: trainer.train_forest_sequential(ds, fc),
                     lambda: oob.oob_score(
                         trainer.train_forest_sequential(ds, fc, **CPU),
                         ds, fc)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


# ------------------------------------------------------------------- OOB

class TestOOB:
    def test_oob_equals_jax(self):
        """pred exactly, score and coverage equal, on the same forest."""
        ds = _dataset()
        fc = ForestConfig(n_trees=8, seed=0, grow=GROW)
        res = run_with_timeout(
            lambda: trainer.train_forest(ds, fc, n_workers=2, **CPU), 120)
        jtrees = _jax_forest(0, 300, 8, 0)
        assert _forests_equal(res.trees, jtrees)
        r = oob.oob_score(res.trees, ds, fc, tree_ids=res.tree_ids, **CPU)
        want = joob.oob_score(jtrees, ds, _jax_fc(fc))
        np.testing.assert_array_equal(r.pred.numpy(), want.pred)
        assert (r.score, r.coverage, r.n_covered) == (
            want.score, want.coverage, want.n_covered)
        assert np.isfinite(r.score) and 0.0 <= r.score <= 1.0
        assert r.coverage > 0.5
        assert r.pred.shape == (ds.n_cases,)
        assert int((r.pred >= 0).sum()) == r.n_covered

    def test_vote_ties_break_as_numpy(self):
        """Two trees out of bag that disagree: the lower class wins, as in
        the JAX package's numpy vote; no tree out: -1."""
        per_tree = np.array([[0, 2, 1, 1], [2, 0, 1, 2]], np.int32)
        mask = np.array([[True, True, False, True],
                         [True, True, False, True]])
        got = oob._vote(torch.as_tensor(per_tree), torch.as_tensor(mask), 3)
        want = joob._vote(per_tree, mask, 3)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, [0, 0, -1, 1])

    def test_oob_ignores_in_bag_trees(self):
        """A case's OOB vote must only see trees whose bootstrap missed it."""
        ds = _dataset(seed=3, n=200)
        fc = ForestConfig(n_trees=5, seed=7, grow=GROW)
        trees = trainer.train_forest_sequential(ds, fc, impl="frontier",
                                                **CPU)
        m = oob.oob_matrix(fc, ds.n_cases)
        for t in range(fc.n_trees):
            counts = sampling.bootstrap_counts(fc.seed, t, ds.n_cases)
            np.testing.assert_array_equal(m[t], counts == 0)
        r = oob.oob_score(trees, ds, fc, **CPU)
        uncovered = ~m.any(axis=0)
        assert (r.pred.numpy()[uncovered] == -1).all()

    def test_oob_requires_bootstrap(self):
        ds = _dataset(n=100)
        fc = ForestConfig(n_trees=2, seed=0, bootstrap=False, grow=GROW)
        trees = trainer.train_forest_sequential(ds, fc, impl="frontier",
                                                **CPU)
        with pytest.raises(ValueError, match="bootstrap"):
            oob.oob_score(trees, ds, fc, **CPU)

    def test_permutation_importance_flags_signal_column(self):
        from repro.core import binning as jbinning
        rng = np.random.default_rng(0)
        n = 500
        c0 = rng.uniform(-2, 2, n)
        noise = [rng.uniform(-2, 2, n), rng.integers(0, 3, n)]
        y = (c0 > 0).astype(np.int64)
        y = np.where(rng.random(n) < 0.1, 1 - y, y)    # 10% label noise
        ds = jbinning.fit([c0, *noise], y,
                          attr_is_cont=[True, True, False], n_classes=2,
                          max_bins=32)
        fc = ForestConfig(n_trees=12, seed=2, mtry=2, grow=GROW)
        trees = trainer.train_forest_sequential(ds, fc, impl="frontier",
                                                **CPU)
        imp = oob.permutation_importance(trees, ds, fc, n_repeats=2, **CPU)
        assert imp.shape == (ds.n_attrs,)
        assert imp[0] == imp.max()
        assert imp[0] > 0
        # the JAX package's importance of the same trees (its pack takes
        # any tree with to_numpy())
        want = joob.permutation_importance(trees, ds, _jax_fc(fc),
                                           n_repeats=2)
        np.testing.assert_allclose(imp, want, rtol=0, atol=1e-12)

    def test_permutation_importance_is_deterministic(self):
        ds = _dataset(seed=5, n=200)
        fc = ForestConfig(n_trees=4, seed=1, grow=GROW)
        trees = trainer.train_forest_sequential(ds, fc, impl="frontier",
                                                **CPU)
        a = oob.permutation_importance(trees, ds, fc, **CPU)
        b = oob.permutation_importance(trees, ds, fc, **CPU)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------- publish + serving

def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


class TestPublishServe:
    def test_acceptance_chaos_train_publish_serve(self, tmp_path):
        """Chaos-trained forest == oracle, finite OOB in the manifest (the
        JAX package's manifest), registry round-trip through the service
        matching Forest.predict(impl="ref")."""
        ds = _dataset()
        fc = ForestConfig(n_trees=6, seed=1, grow=GROW)
        inj = faults.FaultInjector(
            seed=7, spec=faults.FaultSpec(
                crash_p=0.2, dead_workers=frozenset({1})),
            key_fn=lambda tid: tid)
        stats = {}
        res = run_with_timeout(
            lambda: trainer.train_forest(
                ds, fc, n_workers=4, injector=inj,
                fault=FaultPolicy(max_retries=8, backoff_base=1e-4),
                stats_out=stats, **CPU), 240)
        jtrees = _jax_forest(0, 300, 6, 1)
        assert _forests_equal(res.trees, jtrees)
        assert stats["dead_workers"] == [1]

        path = publish.publish_forest(str(tmp_path / "port"), "rf", res, ds,
                                      **CPU)
        meta = registry.manifest_of(path)["metadata"]
        assert np.isfinite(meta["oob_score"])
        assert meta["seed"] == 1 and meta["n_trees"] == 6
        assert meta["mtry"] == fc.resolved_mtry(ds.n_attrs)
        jres = jtrainer.TrainResult(trees=jtrees, tree_ids=list(range(6)),
                                    config=_jax_fc(fc), stats={},
                                    quarantined=[])
        jpath = jpublish.publish_forest(str(tmp_path / "jax"), "rf", jres,
                                        ds)
        assert _manifest(path) == _manifest(jpath)

        loaded, _ = registry.load(path, device="cpu")
        want = F.predict(loaded, ds.x, ds.attr_is_cont, impl="ref").numpy()
        handle = registry.ModelHandle(str(tmp_path / "port"), "rf",
                                      device="cpu")
        svc = BatchPredictService(
            [InferReplica.from_handle(handle, ds.attr_is_cont)
             for _ in range(2)],
            handle=handle, max_batch=64, metrics=Registry())
        n = ds.n_cases
        for uid in range(n):
            svc.submit(PredictRequest(uid=uid, x_row=ds.x[uid]))
        results = run_with_timeout(svc.run_until_drained, 120)
        assert len(results) == n and not svc.failed
        got = np.zeros(n, np.int64)
        for r in results:
            got[r.uid] = r.label
        np.testing.assert_array_equal(got, want)

    def test_publish_forest_metadata_without_oob(self, tmp_path):
        ds = _dataset(n=120)
        fc = ForestConfig(n_trees=2, seed=0, bootstrap=False, grow=GROW)
        res = run_with_timeout(
            lambda: trainer.train_forest(ds, fc, impl="frontier",
                                         n_workers=1, **CPU), 120)
        path = publish.publish_forest(str(tmp_path), "rf", res, ds, **CPU)
        meta = registry.manifest_of(path)["metadata"]
        assert meta["bootstrap"] is False
        assert "oob_score" not in meta
        assert meta["tree_ids"] == [0, 1]
        assert meta["quarantined"] == []
