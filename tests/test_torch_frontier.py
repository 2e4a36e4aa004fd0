"""The slice as a whole: the torch frontier build against the JAX engines.

``repro_torch.core.frontier.build(impl="torch", device="cpu")`` must grow a
tree that ``trees_equal``s both the sequential oracle ``repro.core.c45`` and
``repro.core.frontier.build(impl="jnp")`` on the same binned data: structure
exact, node frequencies within trees_equal's atol 1e-3 / rtol 1e-4.
"""

import numpy as np
import pytest

from conftest import make_tree_dataset
from repro.core import c45
from repro.core import frontier as jf
from repro.core.config import GrowConfig as JaxGrowConfig
from repro.core.tree import predict as jax_predict
from repro.data import datasets as jax_datasets
from repro_torch.core import binning, frontier
from repro_torch.core.config import GrowConfig
from repro_torch.core.tree import predict, trees_equal
from repro_torch.data import datasets


def _port(ds) -> binning.BinnedDataset:
    return binning.from_arrays(ds.x, ds.y, ds.w, ds.attr_is_cont, ds.n_bins,
                               ds.bin_edges, ds.n_classes)


def _check(ds, cfg_kw, *, oracle=True, **build_kw):
    jcfg = JaxGrowConfig(**cfg_kw)
    t_jnp = jf.build(ds, jcfg, impl="jnp", **build_kw)
    t_port = frontier.build(_port(ds), GrowConfig(**cfg_kw), impl="torch",
                            device="cpu", **build_kw)
    assert trees_equal(t_port, t_jnp), (t_port.size, t_jnp.size)
    if oracle:
        t_seq = c45.build(ds, jcfg, capacity=jcfg.max_nodes, **build_kw)
        assert trees_equal(t_port, t_seq), (t_port.size, t_seq.size)
    np.testing.assert_array_equal(
        predict(t_port, ds.x, ds.attr_is_cont).numpy(),
        np.asarray(jax_predict(t_jnp, ds.x, ds.attr_is_cont)))
    return t_port


# Table-1 stand-ins at CPU scale, as tests/test_frontier_pallas_path.py
BUNDLED = [("census_pums", 0.001), ("syd10m9a", 0.00002)]


@pytest.mark.parametrize("name,scale", BUNDLED)
@pytest.mark.parametrize("compact", [True, False])
def test_bundled_datasets_match_oracle(name, scale, compact):
    ds = jax_datasets.load(name, scale=scale, max_bins=16)
    port_ds = datasets.load(name, scale=scale, max_bins=16)
    for f in ("x", "y", "w", "attr_is_cont", "n_bins"):
        np.testing.assert_array_equal(getattr(port_ds, f), getattr(ds, f))
    _check(ds, dict(max_nodes=4096, frontier_slots=32, compact=compact))


@pytest.mark.parametrize("seed,n,n_cont,n_disc,n_classes,slots,unknown,crit", [
    (0, 300, 2, 2, 2, 7, 0.0, "gain"),
    (1, 400, 3, 1, 3, 64, 0.15, "gain"),       # unknowns, 3 classes
    (2, 250, 1, 3, 4, 2, 0.15, "gain_ratio"),
    (3, 350, 0, 3, 2, 64, 0.0, "gain_ratio"),  # discrete only
    (4, 200, 3, 0, 3, 7, 0.15, "gain"),        # continuous only
])
def test_random_datasets_match_oracle(seed, n, n_cont, n_disc, n_classes,
                                      slots, unknown, crit):
    ds = make_tree_dataset(np.random.default_rng(seed), n, n_cont=n_cont,
                           n_disc=n_disc, n_classes=n_classes,
                           unknown_frac=unknown)
    _check(ds, dict(max_nodes=1 << 13, frontier_slots=slots, criterion=crit))


def test_capacity_overflow_matches_jnp(rng):
    ds = make_tree_dataset(rng, 500, n_cont=3, n_disc=2, n_classes=3)
    t = _check(ds, dict(max_nodes=16, frontier_slots=8), oracle=False)
    assert t.size <= 16
    _, rows = frontier.build(_port(ds), GrowConfig(max_nodes=16,
                                                   frontier_slots=8),
                             device="cpu", collect_stats=True)
    assert rows[-1]["overflow"]


def test_max_depth_respected(rng):
    ds = make_tree_dataset(rng, 400, n_cont=2, n_disc=2)
    t = _check(ds, dict(max_depth=3, max_nodes=4096))
    assert t.depth <= 3


def test_attr_mask_and_bootstrap_weights(rng):
    ds = make_tree_dataset(rng, 400, n_cont=3, n_disc=2, unknown_frac=0.1)
    case_w = rng.multinomial(ds.n_cases, np.full(ds.n_cases, 1 / ds.n_cases)
                             ).astype(np.float32)    # bootstrap counts
    mask = np.array([True, False, True, True, False])
    _check(ds, dict(max_nodes=4096, frontier_slots=16), attr_mask=mask,
           case_w=case_w)


def test_collect_stats_rows_match_jax(rng):
    ds = make_tree_dataset(rng, 600, n_cont=2, n_disc=1)
    kw = dict(frontier_slots=16, cost_model="nsq", max_nodes=8192)
    t_j, rows_j = jf.build(ds, JaxGrowConfig(**kw), collect_stats=True)
    t_p, rows_p = frontier.build(_port(ds), GrowConfig(**kw), device="cpu",
                                 collect_stats=True)
    assert trees_equal(t_p, t_j)
    assert len(rows_p) == len(rows_j)
    for rp, rj in zip(rows_p, rows_j):
        assert rp["overflow"] is False
        assert {k: rp[k] for k in rj} == pytest.approx(rj, rel=1e-6)
    assert rows_p[0]["n_processed"] == 1 and rows_p[0]["nap_nodes"] == 1
    assert sum(r["n_processed"] for r in rows_p) == t_p.size


@pytest.mark.parametrize("model", ["alpha", "nlogn"])
def test_cost_models_match_jax(model):
    import jax.numpy as jnp
    import torch
    from repro.core import cost_models as jcm
    from repro_torch.core import cost_models as tcm
    r = np.array([0.0, 1.0, 2.0, 50.0, 999.0, 1001.0, 5e4], np.float32)
    c = np.array([1, 9, 9, 3, 40, 2, 9], np.float32)
    want = np.asarray(jcm.build_att_test(model, n_total_cases=1e4,
                                         r=jnp.asarray(r), c=jnp.asarray(c)))
    got = tcm.build_att_test(model, n_total_cases=1e4, r=torch.as_tensor(r),
                             c=torch.as_tensor(c))
    np.testing.assert_array_equal(got.numpy(), want)


def test_binning_matches_jax(rng):
    """Both packages bin the same raw columns into the same bins."""
    from repro.core import binning as jb
    cols = [rng.normal(size=500), rng.integers(-1, 6, 500),
            np.where(rng.random(500) < .1, np.nan, rng.uniform(size=500)),
            np.full(500, 3.0)]
    kinds = [True, False, True, True]
    y = rng.integers(0, 3, 500)
    for max_bins in (1, 16, 256):
        a = jb.fit(cols, y, attr_is_cont=kinds, max_bins=max_bins)
        b = binning.fit(cols, y, attr_is_cont=kinds, max_bins=max_bins)
        for f in ("x", "y", "w", "attr_is_cont", "n_bins"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        for ea, eb in zip(a.bin_edges, b.bin_edges):
            np.testing.assert_array_equal(ea, eb)
