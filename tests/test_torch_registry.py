"""The torch model registry (repro_torch.infer.registry) against the JAX one.

Both packages write the same on-disk format, so a version published by
either loads in the other with the same arrays (exact) and the same
predictions (exact labels).  The version bookkeeping (``latest_valid``,
``rollback``, ``gc_versions``, retention, stale staging GC) and the canary
hash ``route_bucket`` are run side by side and must agree step for step.
"""

import json
import os

import numpy as np
import pytest
import torch
from conftest import make_tree_dataset

from repro.core import c45
from repro.core.config import GrowConfig as JaxGrowConfig
from repro.infer import forest as JF
from repro.infer import registry as jreg
from repro_torch.core.tree import FIELDS as TREE_FIELDS
from repro_torch.core.tree import tree_from_numpy
from repro_torch.infer import forest as F
from repro_torch.infer import registry as reg


def carry(jtree):
    t = jtree.to_numpy()
    return tree_from_numpy({f: getattr(t, f) for f in TREE_FIELDS}, "cpu")


@pytest.fixture(scope="module")
def ds():
    return make_tree_dataset(np.random.default_rng(0), n=250,
                             unknown_frac=0.1)


@pytest.fixture(scope="module")
def trees(ds):
    rng = np.random.default_rng(1)
    return [c45.build(ds.subset(rng.choice(ds.n_cases, ds.n_cases)),
                      JaxGrowConfig()) for _ in range(3)]


@pytest.fixture(scope="module")
def forests(trees):
    """(JAX forest, port forest) of the same weighted trees."""
    w = np.array([0.5, 1.25, 2.0], np.float32)
    return (JF.Forest.pack(trees, weights=w),
            F.Forest.pack([carry(t) for t in trees], weights=w,
                          device="cpu"))


def _npz(path):
    with np.load(os.path.join(path, "model.npz")) as z:
        return {k: z[k] for k in z.files}


def _assert_same_arrays(fo, jfo):
    for f in F.FIELDS:
        np.testing.assert_array_equal(getattr(fo, f).numpy(),
                                      np.asarray(getattr(jfo, f)), err_msg=f)


class TestCrossPackage:
    def test_jax_publish_loads_in_the_port(self, tmp_path, ds, forests):
        jfo, _ = forests
        path = jreg.publish(str(tmp_path), "m", jfo, metadata={"seed": 3})
        assert reg.verify(path)
        assert reg.latest_valid(str(tmp_path), "m") == path
        fo, manifest = reg.load(path, device="cpu")
        assert manifest == jreg.manifest_of(path)
        assert fo.device == torch.device("cpu")
        _assert_same_arrays(fo, jfo)
        np.testing.assert_array_equal(
            F.predict(fo, ds.x, ds.attr_is_cont).numpy(),
            np.asarray(JF.predict(jfo, ds.x, ds.attr_is_cont)))

    def test_port_publish_loads_in_jax(self, tmp_path, ds, forests):
        jfo, fo = forests
        path = reg.publish(str(tmp_path), "m", fo, metadata={"seed": 3})
        assert jreg.verify(path)
        assert jreg.latest_valid(str(tmp_path), "m") == path
        loaded, _ = jreg.load(path)
        _assert_same_arrays(fo, loaded)
        for impl in ("vmap", "pallas"):
            np.testing.assert_array_equal(
                np.asarray(JF.predict(loaded, ds.x, ds.attr_is_cont,
                                      impl=impl)),
                F.predict(fo, ds.x, ds.attr_is_cont).numpy())

    def test_files_and_manifests_equal(self, tmp_path, forests):
        """Same trees: the same manifest (crc32 per array included) and
        the same npz keys, dtypes and bytes from either package."""
        jfo, fo = forests
        pj = jreg.publish(str(tmp_path / "jax"), "m", jfo, metadata={"a": 1})
        pt = reg.publish(str(tmp_path / "port"), "m", fo, metadata={"a": 1})
        mj, mt = jreg.manifest_of(pj), reg.manifest_of(pt)
        assert mt == mj
        assert [*mt["arrays"]] == list(F.FIELDS)
        zj, zt = _npz(pj), _npz(pt)
        assert list(zt) == list(zj)
        for k in zj:
            assert zt[k].dtype == zj[k].dtype
            np.testing.assert_array_equal(zt[k], zj[k])

    def test_bare_tree_publish_equals_jax(self, tmp_path, ds, trees):
        pj = jreg.publish(str(tmp_path / "jax"), "m", trees[0])
        pt = reg.publish(str(tmp_path / "port"), "m", carry(trees[0]))
        assert reg.manifest_of(pt) == jreg.manifest_of(pj)
        fo, manifest = reg.load(pt, device="cpu")
        assert manifest["n_trees"] == 1
        np.testing.assert_array_equal(
            F.predict(fo, ds.x, ds.attr_is_cont).numpy(),
            np.asarray(JF.predict(jreg.load(pj)[0], ds.x,
                                  ds.attr_is_cont)))

    def test_load_without_device_needs_cuda(self, tmp_path, forests):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is valid")
        path = reg.publish(str(tmp_path), "m", forests[1])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            reg.load(path)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            reg.ModelHandle(str(tmp_path), "m")


def test_route_bucket_equals_jax():
    uids = range(10_000)
    assert [reg.route_bucket(u) for u in uids] == \
        [jreg.route_bucket(u) for u in uids]


# ---------------------------------------------------------- version history
# Each scenario is a list of operations run against both registries, each in
# its own root; every return value and the directory listing must agree.

def _corrupt(path):
    with open(os.path.join(path, "model.npz"), "r+b") as f:
        f.seek(-8, 2)
        f.write(b"\xff" * 8)


def _crash_publish(mod, root, model, monkeypatch):
    def crash(src, dst):
        raise RuntimeError("injected: killed before rename")
    with monkeypatch.context() as m:
        m.setattr(mod.os, "replace", crash)
        with pytest.raises(RuntimeError, match="injected"):
            mod.publish(root, "m", model)
    for d in os.listdir(os.path.join(root, "m")):
        if d.startswith("tmp."):
            os.utime(os.path.join(root, "m", d), (1.0, 1.0))   # stale
    return "crashed"


SCENARIOS = {
    "publish": ["pub", "pub", "pub", "latest"],
    "keep_last": ["pub"] * 5 + ["pub_keep2", "latest"],
    "gc": ["pub"] * 4 + ["gc2", "gc2", "latest"],
    "rollback": ["pub", "pub", "rollback", "latest", "pub", "latest"],
    "rollback_to_empty": ["pub", "rollback", "latest", "rollback_raises"],
    "gc_retired": ["pub", "rollback"] * 4 + ["pub_keep2", "retired"],
    "corrupt_newest": ["pub", "pub", "corrupt", "latest", "verify_newest"],
    "crash_before_rename": ["pub", "crash", "latest", "tmp_left"],
}


def _run(mod, root, model, ops, monkeypatch):
    out = []
    for op in ops:
        if op == "pub":
            out.append(mod.publish(root, "m", model))
        elif op == "pub_keep2":
            out.append(mod.publish(root, "m", model, keep_last=2))
        elif op == "gc2":
            out.append(mod.gc_versions(root, "m", keep_last=2))
        elif op == "latest":
            out.append(mod.latest_valid(root, "m"))
        elif op == "rollback":
            out.append(mod.rollback(root, "m"))
        elif op == "rollback_raises":
            with pytest.raises(FileNotFoundError):
                mod.rollback(root, "m")
            out.append("raised")
        elif op == "retired":
            out.append(mod.list_retired(root, "m"))
        elif op == "corrupt":
            _corrupt(mod.list_versions(root, "m")[-1])
            out.append(None)
        elif op == "verify_newest":
            out.append(mod.verify(mod.list_versions(root, "m")[-1]))
        elif op == "crash":
            out.append(_crash_publish(mod, root, model, monkeypatch))
        elif op == "tmp_left":
            out.append(sorted(d for d in os.listdir(os.path.join(root, "m"))
                              if d.startswith("tmp.")))
    return out


def _rel(v, root):
    if isinstance(v, str):
        return v.replace(root, "<root>")
    if isinstance(v, list):
        return [_rel(x, root) for x in v]
    return v


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_version_history_equals_jax(tmp_path, forests, monkeypatch, name):
    jfo, fo = forests
    rj, rt = str(tmp_path / "jax"), str(tmp_path / "port")
    got = _run(reg, rt, fo, SCENARIOS[name], monkeypatch)
    want = _run(jreg, rj, jfo, SCENARIOS[name], monkeypatch)
    assert _rel(got, rt) == _rel(want, rj)
    assert sorted(os.listdir(os.path.join(rt, "m"))) == \
        sorted(os.listdir(os.path.join(rj, "m")))


class TestHandle:
    def test_hot_swap_and_canary_routing_equal_jax(self, tmp_path, forests):
        jfo, fo = forests
        roots = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
        jreg.publish(roots["jax"], "m", jfo)
        reg.publish(roots["port"], "m", fo)
        hj = jreg.ModelHandle(roots["jax"], "m")
        ht = reg.ModelHandle(roots["port"], "m", device="cpu")
        assert not ht.refresh()
        v2j = jreg.publish(roots["jax"], "m", jfo)
        v2t = reg.publish(roots["port"], "m", fo)
        assert ht.refresh() and hj.refresh()
        assert ht.stable_path == v2t
        _assert_same_arrays(ht.stable, hj.stable)
        for frac in (0.0, 0.25, 1.0):
            hj.set_canary(v2j, frac)
            ht.set_canary(v2t, frac)
            assert [ht.route(u) for u in range(4000)] == \
                [hj.route(u) for u in range(4000)]
        ht.set_canary(v2t, 0.5, shadow=True)
        assert all(ht.route(u) == "stable" for u in range(500))
        assert ht.shadow_model() is ht.canary
        ht.promote_canary()
        assert ht.stable_path == v2t and ht.canary is None
        with pytest.raises(ValueError):
            ht.promote_canary()

    def test_canary_must_verify(self, tmp_path, forests):
        reg.publish(str(tmp_path), "m", forests[1])
        v2 = reg.publish(str(tmp_path), "m", forests[1])
        _corrupt(v2)
        handle = reg.ModelHandle(str(tmp_path), "m", device="cpu")
        assert handle.stable_path.endswith("v00000001")
        with pytest.raises(ValueError, match="verification"):
            handle.set_canary(v2, 0.5)

    def test_handle_requires_published_model(self, tmp_path):
        with pytest.raises(FileNotFoundError):
            reg.ModelHandle(str(tmp_path), "ghost", device="cpu")

    def test_manifest_records_the_forest(self, tmp_path, forests):
        path = reg.publish(str(tmp_path), "m", forests[1],
                           metadata={"note": "x"})
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        fo = forests[1]
        assert (manifest["n_trees"], manifest["capacity"],
                manifest["n_classes"], manifest["n_levels"]) == \
            (fo.n_trees, fo.capacity, fo.n_classes, fo.n_levels)
        assert manifest["metadata"] == {"note": "x"}
