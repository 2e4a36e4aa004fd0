"""The port's scan against ``jax.lax.scan`` (tests/test_scan_util.py's
cases on the same numpy inputs), its unrolled chunk rule, and the loops
routed through it."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.utils import scan as juscan
from repro_torch.utils import scan as uscan


def _jf(c, x):
    return c + x["a"] * 2, {"y": c * x["a"], "z": x["b"] + 1}


def _tf(c, x):
    return c + x["a"] * 2, {"y": c * x["a"], "z": x["b"] + 1}


def test_matches_lax_scan():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=5).astype(np.float32), rng.normal(
        size=(5, 3)).astype(np.float32)
    c1, y1 = jax.lax.scan(_jf, jnp.float32(0), {"a": jnp.asarray(a),
                                               "b": jnp.asarray(b)})
    for unroll in (False, True):
        with (uscan.unrolled() if unroll else torch.no_grad()):
            c2, y2 = uscan.scan(_tf, torch.tensor(0.0),
                                {"a": torch.from_numpy(a),
                                 "b": torch.from_numpy(b)})
        np.testing.assert_allclose(float(c2), float(c1), rtol=1e-6)
        for k in y1:
            np.testing.assert_allclose(y2[k].numpy(), np.asarray(y1[k]),
                                       rtol=1e-6)


def test_none_ys():
    def f(c, x):
        return c + x, None
    c, ys = uscan.scan(f, torch.tensor(0.0), torch.arange(4.0))
    assert ys is None and float(c) == 6.0


def test_length_only():
    def f(c, _):
        return c * 2, c
    c, ys = uscan.scan(f, torch.tensor(1.0), None, length=3)
    assert float(c) == 8.0
    np.testing.assert_allclose(ys.numpy(), [1, 2, 4])
    jc, jys = jax.lax.scan(lambda c, _: (c * 2, c), jnp.float32(1), None,
                           length=3)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys))


def test_analysis_chunk_as_jax():
    for args in ((512, 4096), (512, 32768), (512, 1024), (128, 100)):
        assert uscan.analysis_chunk(*args) == juscan.analysis_chunk(*args)
        with uscan.unrolled(), juscan.unrolled():
            assert uscan.is_unrolled() and juscan.is_unrolled()
            assert uscan.analysis_chunk(*args) == juscan.analysis_chunk(*args)
    assert not uscan.is_unrolled()


def test_model_loss_invariant_under_unroll():
    """Reduced gemma2_9b: the loss with the CE chunk loop unrolled (its
    chunks grown by analysis_chunk) equals the production one."""
    from repro_torch.configs import base
    from repro_torch.models.model import build_model
    cfg = base.reduced(base.get_config("gemma2_9b"), dtype="float32")
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
             for k in ("tokens", "labels")}
    with torch.no_grad():
        l1, _ = model.loss_fn(params, batch)
        with uscan.unrolled():
            l2, _ = model.loss_fn(params, batch)
    assert abs(float(l1) - float(l2)) < 2e-3


def test_counted_scan_runs_one_step_on_meta_under_a_counter():
    """On meta tensors under a cost counter with autograd off, the scan
    runs its body once and the counters count it n times: the same flops
    and bytes as every step run."""
    from repro_torch.launch import roofline

    def f(c, x):
        return c @ x, (c * 2).sum(0)

    def run(xs):
        return uscan.scan(f, torch.zeros(8, 8, device=xs.device), xs)

    calls = []

    def counted_f(c, x):
        calls.append(1)
        return f(c, x)

    meta = torch.zeros(6, 8, 8, device="meta")
    with torch.no_grad():
        (_, ys), once = roofline.count_costs(
            lambda xs: uscan.scan(counted_f, torch.zeros(
                8, 8, device="meta"), xs), meta)
        assert len(calls) == 1 and ys.shape == (6, 8)
        _, every = roofline.count_costs(run, torch.zeros(6, 8, 8))
    assert once.device_flops == every.device_flops == 6 * 2 * 8 ** 3
    assert once.device_bytes == every.device_bytes
    assert once.n_ops == every.n_ops
