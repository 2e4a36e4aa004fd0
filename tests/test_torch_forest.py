"""The torch packed forest (repro_torch.infer.forest) against the JAX one.

Trees are grown by the JAX package (``c45`` and ``frontier(impl="jnp")``)
and carried across with ``tree_from_numpy``; both packages pack them and
predict on the same numpy cases.  Everything here is exact: packed fields,
the node table, the heavy-child table, ``n_levels``, per-tree labels and
votes.  The JAX ``pallas`` runs go through ``repro.kernels.ops``, which
picks interpret mode on the CPU.
"""

import numpy as np
import pytest
import torch
from conftest import make_tree_dataset

from repro.core import binning as jbinning
from repro.core import c45
from repro.core import frontier as jfrontier
from repro.core.config import GrowConfig as JaxGrowConfig
from repro.data import datasets as jdatasets
from repro.infer import forest as JF
from repro_torch.core.tree import FIELDS as TREE_FIELDS
from repro_torch.core.tree import predict as tree_predict
from repro_torch.core.tree import tree_from_numpy
from repro_torch.infer import forest as F

ENGINES = ("c45", "frontier")
PORT_IMPLS = ("ref", "torch")
JAX_IMPLS = ("ref", "vmap", "pallas")


def carry(jtree):
    """A JAX tree as a port tree on the CPU."""
    t = jtree.to_numpy()
    return tree_from_numpy({f: getattr(t, f) for f in TREE_FIELDS}, "cpu")


def grow(ds, engine, cfg=JaxGrowConfig(max_nodes=4096, frontier_slots=16)):
    if engine == "c45":
        return c45.build(ds, cfg, capacity=cfg.max_nodes)
    return jfrontier.build(ds, cfg, impl="jnp")


def bootstrap_trees(ds, seed, engine, n_trees=4):
    rng = np.random.default_rng(seed)
    return [grow(ds.subset(rng.choice(ds.n_cases, ds.n_cases)), engine)
            for _ in range(n_trees)]


@pytest.fixture(scope="module")
def ds():
    return make_tree_dataset(np.random.default_rng(0), n=350,
                             unknown_frac=0.15)


@pytest.fixture(scope="module", params=ENGINES)
def trees(request, ds):
    return bootstrap_trees(ds, 1, request.param)


def both(trees, **kw):
    """(JAX forest, port forest) of the same trees."""
    return (JF.Forest.pack(trees, **kw),
            F.Forest.pack([carry(t) for t in trees], device="cpu", **kw))


def assert_same_forest(fo, jfo):
    for f in F.FIELDS:
        got, want = getattr(fo, f).numpy(), np.asarray(getattr(jfo, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(fo.node_table().numpy(),
                                  np.asarray(jfo.node_table()))
    assert (fo.n_trees, fo.capacity, fo.n_classes, fo.n_levels) == \
        (jfo.n_trees, jfo.capacity, jfo.n_classes, jfo.n_levels)


def jax_labels(jfo, x, cont, impl, **kw):
    return np.asarray(JF.predict_per_tree(jfo, x, cont, impl=impl, **kw))


class TestPack:
    def test_fields_table_and_levels_equal_jax(self, trees):
        jfo, fo = both(trees)
        assert_same_forest(fo, jfo)
        assert fo.n_levels == max(t.depth for t in trees) + 1

    @pytest.mark.parametrize("capacity", [None, 4096])
    def test_padding_equals_jax(self, trees, capacity):
        jfo, fo = both(trees, capacity=capacity,
                       weights=np.arange(1, 5, dtype=np.float32))
        assert_same_forest(fo, jfo)

    def test_unpack_round_trips_each_tree(self, ds, trees):
        _, fo = both(trees)
        for i, t in enumerate(trees):
            back = fo.tree(i)
            assert back.size == t.size
            np.testing.assert_array_equal(
                tree_predict(back, ds.x, ds.attr_is_cont).numpy(),
                tree_predict(carry(t), ds.x, ds.attr_is_cont).numpy())

    def test_pack_rejects_mixed_classes_and_bad_weights(self, ds):
        t2 = carry(c45.build(ds, JaxGrowConfig()))
        t3 = carry(c45.build(
            jbinning.fit([np.array([0, 1, 2])], np.array([0, 1, 2]),
                         attr_is_cont=[False], n_classes=3),
            JaxGrowConfig()))
        with pytest.raises(ValueError):
            F.Forest.pack([t2, t3], device="cpu")
        with pytest.raises(ValueError):
            F.Forest.pack([t2], weights=[1.0, 2.0], device="cpu")
        with pytest.raises(ValueError):
            F.Forest.pack([], device="cpu")
        with pytest.raises(ValueError):
            F.Forest.pack([t2], capacity=t2.size - 1, device="cpu")

    def test_forest_from_numpy_carries_a_jax_forest(self, ds, trees):
        jfo, fo = both(trees, weights=np.linspace(0.5, 2, 4))
        carried = F.forest_from_numpy(
            {f: np.asarray(getattr(jfo, f)) for f in F.FIELDS}, "cpu")
        assert_same_forest(carried, jfo)
        for f, arr in fo.to_numpy().items():
            np.testing.assert_array_equal(arr, getattr(carried, f).numpy())


class TestPredictEqualsJax:
    @pytest.mark.parametrize("impl", PORT_IMPLS)
    def test_per_tree_labels(self, ds, trees, impl):
        """Every port impl == every JAX impl, unknowns included."""
        jfo, fo = both(trees)
        got = F.predict_per_tree(fo, ds.x, ds.attr_is_cont, impl=impl)
        assert got.dtype == torch.int32 and got.shape == (4, ds.n_cases)
        for jimpl in JAX_IMPLS:
            np.testing.assert_array_equal(
                got.numpy(), jax_labels(jfo, ds.x, ds.attr_is_cont, jimpl),
                err_msg=jimpl)

    @pytest.mark.parametrize("impl", PORT_IMPLS)
    @pytest.mark.parametrize("max_depth", [0, 1, 3])
    def test_truncated_descent(self, ds, trees, impl, max_depth):
        jfo, fo = both(trees)
        got = F.predict_per_tree(fo, ds.x, ds.attr_is_cont, impl=impl,
                                 max_depth=max_depth)
        for jimpl in ("vmap", "pallas"):
            np.testing.assert_array_equal(
                got.numpy(), jax_labels(jfo, ds.x, ds.attr_is_cont, jimpl,
                                        max_depth=max_depth))

    @pytest.mark.parametrize("impl", PORT_IMPLS)
    def test_discrete_and_wide_splits(self, impl):
        """An 11-way discrete split; unknowns follow its heavy child."""
        xs, ys = [], []
        for v in range(11):
            reps = 40 if v == 9 else 4
            xs += [v] * reps
            ys += [1 if v == 9 else v % 2] * reps
        ds = jbinning.fit([np.array(xs)], np.array(ys),
                          attr_is_cont=[False], n_classes=2)
        tree = c45.build(ds, JaxGrowConfig(min_objs=1.0))
        jfo, fo = both([tree, tree])
        probe = np.array([[3], [9], [-1], [10], [0]], np.int32)
        got = F.predict_per_tree(fo, probe, ds.attr_is_cont, impl=impl)
        for jimpl in JAX_IMPLS:
            np.testing.assert_array_equal(
                got.numpy(), jax_labels(jfo, probe, ds.attr_is_cont, jimpl))
        assert got[0, 2] == 1              # unknown followed the heavy child

    @pytest.mark.parametrize("impl", PORT_IMPLS)
    def test_census_wide_discrete_forest(self, impl):
        """census_pums stand-in: 40 attributes, multiway discrete splits."""
        ds = jdatasets.load("census_pums", scale=0.001, max_bins=16)
        trees = bootstrap_trees(ds, 2, "frontier", n_trees=3)
        jfo, fo = both(trees)
        x = ds.x.copy()
        x[np.random.default_rng(3).random(x.shape) < 0.05] = -1
        got = F.predict_per_tree(fo, x, ds.attr_is_cont, impl=impl)
        for jimpl in ("vmap", "pallas"):
            np.testing.assert_array_equal(
                got.numpy(), jax_labels(jfo, x, ds.attr_is_cont, jimpl))


class TestVote:
    def test_weighted_vote_tally(self):
        per_tree = torch.tensor([[0, 1], [0, 1], [1, 0]], dtype=torch.int32)
        majority = F.vote(per_tree, torch.ones(3), n_classes=2)
        np.testing.assert_array_equal(majority.numpy(), [0, 1])
        skewed = F.vote(per_tree, torch.tensor([1.0, 1.0, 5.0]), n_classes=2)
        np.testing.assert_array_equal(skewed.numpy(), [1, 0])
        # a tie breaks to the lowest class, as jnp.argmax does
        tie = F.vote(torch.tensor([[0, 1], [1, 0]], dtype=torch.int32),
                     torch.ones(2), n_classes=2)
        np.testing.assert_array_equal(tie.numpy(), [0, 0])

    @pytest.mark.parametrize("impl", PORT_IMPLS)
    @pytest.mark.parametrize("weights", ["unit", "random"])
    @pytest.mark.parametrize("weighted", [True, False])
    def test_predict_equals_jax(self, ds, trees, impl, weights, weighted):
        w = (None if weights == "unit" else
             np.random.default_rng(4).uniform(0.5, 2.0, 4).astype(np.float32))
        jfo, fo = both(trees, weights=w)
        got = F.predict(fo, ds.x, ds.attr_is_cont, impl=impl,
                        weighted=weighted)
        assert got.dtype == torch.int32 and got.shape == (ds.n_cases,)
        for jimpl in ("vmap", "pallas"):
            np.testing.assert_array_equal(
                got.numpy(),
                np.asarray(JF.predict(jfo, ds.x, ds.attr_is_cont,
                                      impl=jimpl, weighted=weighted)))

    @pytest.mark.parametrize("impl", PORT_IMPLS)
    def test_single_tree_forest_is_identity(self, ds, trees, impl):
        tree = carry(trees[0])
        fo = F.Forest.pack([tree], device="cpu")
        np.testing.assert_array_equal(
            F.predict(fo, ds.x, ds.attr_is_cont, impl=impl).numpy(),
            tree_predict(tree, ds.x, ds.attr_is_cont).numpy())


class TestDispatch:
    def test_default_impl_on_the_cpu_is_torch(self, ds, trees):
        _, fo = both(trees)
        np.testing.assert_array_equal(
            F.predict_per_tree(fo, ds.x, ds.attr_is_cont).numpy(),
            F.predict_per_tree(fo, ds.x, ds.attr_is_cont,
                               impl="torch").numpy())

    def test_cuda_impl_refuses_a_cpu_forest(self, ds, trees):
        _, fo = both(trees)
        with pytest.raises(ValueError, match="needs a forest on a CUDA"):
            F.predict_per_tree(fo, ds.x, ds.attr_is_cont, impl="cuda")
        with pytest.raises(ValueError, match="unknown impl"):
            F.predict_per_tree(fo, ds.x, ds.attr_is_cont, impl="vmap")

    def test_pack_without_device_needs_cuda(self, trees):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is valid")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            F.Forest.pack([carry(trees[0])])
