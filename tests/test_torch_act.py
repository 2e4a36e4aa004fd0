"""The port's activation-sharding helpers ask for the JAX package's spec
for each shape and knob (tests/test_sharding.py's capture of
``_constrain``), and each is a no-op with no context."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sharding import act as jact
from repro_torch.sharding import act

HELPERS = ("shard_batch", "shard_batch_tp_last", "shard_frontier_hist",
           "shard_active_cases", "shard_kv_capture", "shard_experts")
SHAPES = ((128, 9), (129,), (128,), (256, 9, 257, 2), (255, 9, 257, 2),
          (16, 4096, 8, 256), (16, 4095, 8, 256), (1, 4096, 8, 256),
          (16, 64, 4096), (16, 63, 4096), (3, 5, 7))
CONTEXTS = (
    (("data",), 16, "model", 16, {}),
    (("pod", "data"), 32, "model", 16, {}),
    (("data",), 16, "model", 16, {"moe2d": True}),
    (("data",), 16, "model", 16, {"yadt_rs": False}),
    (("data",), 16, "model", 16, {"yadt_compact": False}),
    (("data",), 16, "model", 16, {"kv_seq_shard": True}),
    (("data",), 1, "model", 1, {"moe2d": True, "kv_seq_shard": True}),
)


def norm(spec) -> tuple:
    def entry(e):
        if e is None or isinstance(e, str):
            return e
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return tuple(entry(e) for e in spec)


def _capture(monkeypatch, module):
    seen = []
    monkeypatch.setattr(module, "_constrain",
                        lambda x, spec: seen.append(norm(spec)) or x)
    return seen


@pytest.mark.parametrize("ctx", range(len(CONTEXTS)))
@pytest.mark.parametrize("helper", HELPERS)
def test_helper_asks_for_the_jax_spec(monkeypatch, helper, ctx):
    dp, dp_size, tp, tp_size, knobs = CONTEXTS[ctx]
    got, want = _capture(monkeypatch, act), _capture(monkeypatch, jact)
    for shape in SHAPES:
        if helper == "shard_kv_capture" and len(shape) < 2:
            continue                      # (B, S, KV, hd) in both packages
        x = torch.zeros(shape, device="meta")
        with act.activation_sharding(dp, dp_size, tp, tp_size, **knobs):
            assert getattr(act, helper)(x) is x
        with jact.activation_sharding(dp, dp_size, tp, tp_size, **knobs):
            getattr(jact, helper)(np.zeros(shape, np.int8))
        assert got == want, (shape, got, want)


@pytest.mark.parametrize("helper", HELPERS)
def test_helper_is_a_no_op_without_a_context(monkeypatch, helper):
    seen = _capture(monkeypatch, act)
    x = torch.zeros((128, 9))
    assert getattr(act, helper)(x) is x
    assert not seen and not act._STATE["enabled"]


def test_from_mesh_takes_the_mesh_axes():
    from repro_torch.launch.mesh import abstract_mesh
    for sizes in ((16, 16), (2, 16, 16)):
        axes = ("data", "model") if len(sizes) == 2 else (
            "pod", "data", "model")
        with act.from_mesh(abstract_mesh(sizes, axes), moe2d=True):
            assert act._STATE["dp"] == axes[:-1]
            assert act._STATE["dp_size"] == int(np.prod(sizes[:-1]))
            assert act._STATE["tp_size"] == 16 and act._STATE["moe2d"]
    assert not act._STATE["enabled"] and not act._STATE["moe2d"]


def test_constrain_is_the_identity_on_a_plain_tensor():
    x = torch.ones(4, 4)
    with act.activation_sharding(("data",), 2, "model", 2):
        assert act.shard_batch_tp_last(x) is x
        assert act.shard_experts(x) is x
    assert jnp.asarray(0.0) == 0.0       # the JAX side stays importable
