"""The generators repeat for a seed and keep their configuration's
schema."""

import pytest
import torch

from bench.tests import _small

SEEDS = (7, 2**31 + 123)


@pytest.mark.parametrize("name,n", [("syd10m9a", 5000)])
@pytest.mark.parametrize("seed", SEEDS)
def test_repeats_for_a_seed(name, n, seed):
    _, a = _small.data(name, n, seed)
    _, b = _small.data(name, n, seed)
    _, c = _small.data(name, n, seed + 1)
    assert torch.equal(a.x, b.x) and torch.equal(a.y, b.y)
    assert a.n_bins == b.n_bins
    assert not torch.equal(a.x, c.x)


@pytest.mark.parametrize("name,n", [("syd10m9a", 20000)])
def test_schema(name, n):
    cfg, d = _small.data(name, n, 3)
    assert d.x.shape == (n, len(cfg["attributes"]))
    assert d.x.dtype == torch.int32
    assert d.attr_is_cont == [a["kind"] == "continuous"
                              for a in cfg["attributes"]]
    assert int(d.x.min()) >= 0
    for j, a in enumerate(cfg["attributes"]):
        assert int(d.x[:, j].max()) < d.n_bins[j]
        if a["kind"] == "discrete":
            assert d.n_bins[j] <= a["values"]
        else:
            assert d.n_bins[j] <= cfg["max_bins"]
    assert set(d.y.unique().tolist()) <= set(range(cfg["n_classes"]))
    assert d.y.unique().numel() > 1


def test_another_order_grows_the_same_tree():
    from bench import reference
    from bench.dataset import permuted
    cfg, d = _small.data("syd10m9a", 20000, 4)
    a = _small.oracle(permuted(d, 1), cfg["grow"])
    b = _small.oracle(permuted(d, 2**31 + 2), cfg["grow"])
    assert not torch.equal(permuted(d, 1).x, permuted(d, 2).x)
    assert reference.compare(a.tree, b.tree) == 0
