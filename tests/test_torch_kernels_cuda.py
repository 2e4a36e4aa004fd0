"""The CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU with nvcc (the kernels have no CPU mode); without
one each test skips.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Histogram: exact for integral weights, atol 1e-4 / rtol 1e-5 for random f32
weights (device atomics add in no fixed order).  Split gain: bins and the
-inf pattern exact, scores within 1e-5 * (1 + |score|) (the discrete branch
sums its bins in another order than torch.sum).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,a,b,c,k", [
    (64, 1, 4, 2, 3), (200, 3, 13, 4, 10), (130, 2, 7, 23, 5),
    (96, 4, 128, 3, 8), (20_000, 9, 256, 2, 256), (5_000, 40, 128, 2, 256)])
@pytest.mark.parametrize("integral", [True, False])
def test_histogram_kernel_matches_plain(dev, n, a, b, c, k, integral):
    from repro_torch.kernels import histogram, ref
    rng = np.random.default_rng(n + a)
    x = torch.as_tensor(rng.integers(-1, b, (n, a)).astype(np.int32),
                        device=dev)
    y = torch.as_tensor(rng.integers(0, c, n).astype(np.int32), device=dev)
    w = torch.as_tensor((rng.integers(0, 4, n) if integral else
                         rng.uniform(0.1, 2.0, n)).astype(np.float32),
                        device=dev)
    slot = torch.as_tensor(rng.integers(-1, k, n).astype(np.int32),
                           device=dev)
    kw = dict(n_slots=k, n_bins=b, n_classes=c)
    before = histogram.LAUNCHES
    got = histogram.frontier_histogram(x, y, w, slot, **kw)
    want = ref.frontier_histogram_ref(x, y, w, slot, **kw)
    torch.cuda.synchronize()
    assert histogram.LAUNCHES == before + 1
    if integral:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("criterion", ["gain", "gain_ratio"])
@pytest.mark.parametrize("k,a,b,c", [(4, 3, 8, 2), (10, 5, 13, 4),
                                     (16, 6, 13, 23), (7, 5, 300, 3),
                                     (256, 9, 256, 2), (3, 4, 1, 2)])
def test_split_gain_kernel_matches_plain(dev, k, a, b, c, criterion):
    from repro_torch.kernels import ref, split_gain
    rng = np.random.default_rng(k * a)
    hist = torch.as_tensor(rng.integers(0, 6, (k, a, b, c)).astype(
        np.float32) * (rng.random((k, a, b, c)) < 0.7), device=dev)
    tw = hist.sum((1, 2, 3)) / a + torch.as_tensor(
        rng.integers(0, 4, k).astype(np.float32), device=dev)
    cont = torch.as_tensor(rng.random(a) < 0.5, device=dev)
    nb = torch.as_tensor(rng.integers(1, b + 1, a).astype(np.int32),
                         device=dev)
    for min_objs in (2.0, 0.0):
        s_k, b_k = split_gain.split_gain(hist, tw, cont, nb,
                                         min_objs=min_objs,
                                         criterion=criterion)
        s_r, b_r = ref.split_gain_ref(hist, tw, cont, nb, min_objs=min_objs,
                                      criterion=criterion)
        assert torch.equal(b_k, b_r)
        fin = torch.isfinite(s_r)
        assert torch.equal(fin, torch.isfinite(s_k))
        assert torch.all((s_k[fin] - s_r[fin]).abs()
                         <= 1e-5 * (1 + s_r[fin].abs()))


def test_build_cuda_equals_torch_on_the_card(dev):
    from repro_torch.core import frontier
    from repro_torch.core.config import GrowConfig
    from repro_torch.core.tree import trees_equal
    from repro_torch.data import datasets
    from repro_torch.kernels import histogram, split_gain
    for name, scale in (("census_pums", 0.01), ("syd10m9a", 0.001)):
        ds = datasets.load(name, scale=scale, max_bins=64)
        cfg = GrowConfig(max_nodes=1 << 14, frontier_slots=64)
        h0, g0 = histogram.LAUNCHES, split_gain.LAUNCHES
        t_cuda = frontier.build(ds, cfg)
        assert histogram.LAUNCHES > h0 and split_gain.LAUNCHES > g0
        t_torch = frontier.build(ds, cfg, impl="torch", device=dev)
        assert trees_equal(t_cuda, t_torch)
