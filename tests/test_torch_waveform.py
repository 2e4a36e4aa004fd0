"""Waveform-40 through the port: the port's copy of the generator keeps the
stated schema, and the port's frontier build grows the tree of the
benchmark's plain reference (``bench/reference.py``) on the benchmark's
frozen generator (``bench/generators/waveform.py``): 40 continuous
attributes and 3 classes, so the general split-gain path.  On the card,
``impl="cuda"`` (the shared-memory split-gain kernel) grows the tree of
``impl="torch"``."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from _frontier_sets import one_thread  # noqa: E402,F401
from bench import harness, reference, spec  # noqa: E402
from repro_torch.core import frontier  # noqa: E402
from repro_torch.core.config import GrowConfig  # noqa: E402
from repro_torch.core.tree import trees_equal  # noqa: E402
from repro_torch.data import datasets, waveform  # noqa: E402


def _frozen(n: int, seed: int):
    cfg = spec.config("waveform40")
    cfg["n_cases"] = n
    return cfg, spec.generator(cfg["generator"]).generate(cfg, seed, "cpu")


# (cases, node capacity): the 2,048 cap is hit at 20k cases; min_objs 30
# at 3k cases lets the tree end on its own.  Each superstep of the plain
# path scores the whole (256, 40, 257, 3) histogram: ~0.9 s on one thread.
@pytest.mark.parametrize("n,cap,min_objs", [(20_000, 2_048, 2.0),
                                            (3_000, 1 << 18, 30.0)])
@pytest.mark.parametrize("seed", (0, 7, 2**31 + 9))
@pytest.mark.usefixtures("one_thread")
def test_port_grows_the_reference_tree(n, cap, min_objs, seed):
    cfg, d = _frozen(n, seed)
    grow = {**cfg["grow"], "max_nodes": cap, "min_objs": min_objs}
    tested = harness.host_tree(
        harness.port_builder(grow, "cpu")(harness.dataset(d)))
    ref = reference.grow(d.x, d.y, n_bins=d.n_bins,
                         attr_is_cont=d.attr_is_cont, n_classes=3,
                         grow=reference.Grow.of(grow), tested=tested)
    assert ref.overflow == (cap < 1 << 18)
    assert ref.n_nodes > 100
    assert reference.compare(tested, ref.tree) == 0


def test_port_generator_keeps_the_schema():
    n = 100_000
    ds = datasets.load("waveform40", scale=n / 10_000_000, seed=3,
                       max_bins=256)
    assert ds.n_cases == n and ds.n_attrs == 40 and ds.n_classes == 3
    assert ds.attr_is_cont.all()
    assert ds.attr_names == waveform.ATTR_NAMES
    assert ds.attr_names[0] == "wave01" and ds.attr_names[-1] == "noise40"
    share = np.bincount(ds.y, minlength=3) / n
    np.testing.assert_allclose(share, 1 / 3, atol=0.01)

    # the raw values: bin upper edges stand for the values, so read the
    # generator's draws again from the same seed
    rng = np.random.default_rng(3)
    y = rng.integers(0, 3, n)
    np.testing.assert_array_equal(y, ds.y)
    u = rng.random(n)
    h = waveform.base_waves()
    first = h[[a for a, _ in waveform.CLASS_WAVES]][y]
    second = h[[b for _, b in waveform.CLASS_WAVES]][y]
    x = np.stack([u * first[:, j] + (1 - u) * second[:, j]
                  + rng.standard_normal(n) for j in range(21)]
                 + [rng.standard_normal(n) for _ in range(19)], axis=1)
    # the binned columns are these values' ranks
    for j in (0, 10, 39):
        edges = ds.bin_edges[j]
        np.testing.assert_array_equal(
            np.searchsorted(edges, x[:, j], side="left"), ds.x[:, j])
    m = np.arange(1, 22)
    h1 = np.maximum(6 - np.abs(m - 11), 0)
    h2 = np.maximum(6 - np.abs(m - 15), 0)
    np.testing.assert_allclose(x[y == 0, :21].mean(0), (h1 + h2) / 2,
                               atol=0.1)
    noise = x[:, 21:]
    np.testing.assert_allclose(noise.mean(0), 0, atol=0.05)
    np.testing.assert_allclose(noise.var(0), 1, atol=0.05)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_cuda_build_equals_torch_build(cuda_device):
    ds = datasets.load("waveform40", scale=0.02, seed=1, max_bins=256)
    cfg = GrowConfig(max_nodes=1 << 15, frontier_slots=256)
    a = frontier.build(ds, cfg, impl="cuda", device=cuda_device)
    b = frontier.build(ds, cfg, impl="torch", device=cuda_device)
    assert int(a.n_nodes) > 1000
    assert trees_equal(a, b)
