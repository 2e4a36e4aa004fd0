"""The port's LM stack on the CPU against the JAX package.

Reduced configs (``reduced()``: d_model 128, 4 heads over 2 KV heads,
head_dim 32, window 64): gemma2_9b (local/global, softcaps) and yi_6b
(global GQA) in f32, gemma2_9b with 3 layers (one scanned cycle plus a
tail layer), and gemma2_9b in bf16.  The JAX ``transformer.init`` weights
are carried across by ``params_from_jax``; both packages then run the same
numpy tokens: forward hidden states and cache entries, prefill logits and
caches, and 6 teacher-forced ``decode_step``s with per-row positions
(rows at S and S - 5), on a prompt longer than the window where the config
has one (the ring wraps).

Tolerances: f32 atol 2e-5 on values up to about 4 (measured max 6.2e-6:
matmul and reduction order); bf16 atol 0.1 (measured max 0.055, about 3.5
bf16 steps at that size: bf16 rounds at other places in the two
frameworks' matmuls).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import model as jmodel
from repro.models import transformer as jtr
from repro_torch.configs import base as tbase
from repro_torch.models import kvcache, layers
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttr

# (arch, dtype, prompt length, layer override)
CASES = {
    "gemma2_f32_ring": ("gemma2_9b", "float32", 80, None),
    "yi_f32": ("yi_6b", "float32", 40, None),
    "gemma2_f32_tail": ("gemma2_9b", "float32", 20, 3),
    "gemma2_bf16_ring": ("gemma2_9b", "bfloat16", 80, None),
}
TOL = {"float32": 2e-5, "bfloat16": 0.1}
BATCH, DECODE_STEPS, BACK = 2, 6, 5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0)


def _configs(arch, dtype, n_layers):
    over = dict(dtype=dtype)
    if n_layers:
        over["n_layers"] = n_layers
    return (jbase.reduced(jbase.get_config(arch), **over),
            tbase.reduced(tbase.get_config(arch), **over))


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """Both packages over one case; everything the tests compare."""
    arch, dtype, s, n_layers = CASES[request.param]
    cj, ct = _configs(arch, dtype, n_layers)
    pj = jtr.init(jax.random.key(0), cj)
    pt = ttr.params_from_jax(jax.tree.map(np.asarray, pj), ct, device="cpu")
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cj.vocab_size, (BATCH, s)).astype(np.int32)
    out = dict(case=request.param, dtype=dtype, cj=cj, ct=ct, s=s)
    out["fwd_j"] = jtr.forward(pj, cj, jnp.asarray(tokens),
                               capture_cache=True, remat=False)
    out["fwd_t"] = pt(torch.as_tensor(tokens), capture_cache=True)
    max_seq = s + 16
    lj, cache_j = jmodel.build_model(cj).prefill(pj, jnp.asarray(tokens),
                                                 max_seq=max_seq)
    lt, cache_t = tmodel.build_model(ct).prefill(
        pt, torch.as_tensor(tokens), max_seq=max_seq)
    out["prefill"] = (lj, lt, [dict(c) for c in cache_j],
                      [{k: v.clone() for k, v in c.items()} for c in cache_t])
    pos = np.array([s, s - BACK])
    steps = []
    dj = jmodel.build_model(cj).decode_step
    dt = tmodel.build_model(ct).decode_step
    for t in range(DECODE_STEPS):
        tok = rng.integers(1, cj.vocab_size, (BATCH, 1)).astype(np.int32)
        a, cache_j = dj(pj, cache_j, jnp.asarray(tok),
                        jnp.asarray(pos + t, jnp.int32))
        same = cache_t
        b, cache_t = dt(pt, cache_t, torch.as_tensor(tok),
                        torch.as_tensor(pos + t))
        assert cache_t is same            # the port decodes in place
        steps.append((a, b))
    out["decode"] = (steps, cache_j, cache_t)
    return out


def test_forward_hidden_states_equal_jax(run):
    (xj, _, _), (xt, _) = run["fwd_j"], run["fwd_t"]
    assert tuple(xt.shape) == xj.shape
    _close(xt, xj, run["dtype"])


def test_forward_cache_entries_equal_jax(run):
    (_, ej, _), (_, et) = run["fwd_j"], run["fwd_t"]
    assert len(et) == len(ej) == run["ct"].n_layers
    for i, (a, b) in enumerate(zip(ej, et)):
        assert set(a) == set(b) == {"k", "v"}
        for k in ("k", "v"):
            assert tuple(b[k].shape) == a[k].shape, (i, k)
            _close(b[k], a[k], run["dtype"])


def test_prefill_logits_and_cache_equal_jax(run):
    lj, lt, cache_j, cache_t = run["prefill"]
    assert tuple(lt.shape) == lj.shape == (BATCH, run["ct"].vocab_size)
    _close(lt, lj, run["dtype"])
    for a, b in zip(cache_j, cache_t):
        for k in ("k", "v"):
            assert tuple(b[k].shape) == a[k].shape
            assert b[k].dtype == layers.torch_dtype(run["ct"].dtype)
            _close(b[k], a[k], run["dtype"])


def test_teacher_forced_decode_equals_jax(run):
    steps, cache_j, cache_t = run["decode"]
    for a, b in steps:
        assert tuple(b.shape) == a.shape
        _close(b, a, run["dtype"])
    for a, b in zip(cache_j, cache_t):
        for k in ("k", "v"):
            _close(b[k], a[k], run["dtype"])


def test_local_layers_wrap_their_ring():
    """The ring cases really wrap: prompt and decode pass the window."""
    for arch, _, s, _ in CASES.values():
        cfg = tbase.reduced(tbase.get_config(arch))
        if "local" in cfg.block_pattern:
            assert cfg.window == 64
    assert CASES["gemma2_f32_ring"][2] > 64


def test_params_from_jax_fills_layers_in_order():
    cj, ct = _configs("gemma2_9b", "float32", 3)
    pj = jtr.init(jax.random.key(1), cj)
    pt = ttr.params_from_jax(jax.tree.map(np.asarray, pj), ct, device="cpu")
    assert [layer.kind for layer in pt.layers] == ["local", "global", "local"]
    for i, layer in enumerate(pt.layers):
        want = jtr.layer_params(pj, cj, i)["attn"]["wq"]
        np.testing.assert_array_equal(layer.attn["wq"].detach().numpy(), want)
    np.testing.assert_array_equal(pt.lm_head.detach().numpy(), pj["lm_head"])


def test_init_draws_the_stated_shapes_and_dtypes():
    cfg = tbase.reduced(tbase.get_config("gemma2_9b"))
    gen = torch.Generator("cpu").manual_seed(0)
    pt = tmodel.build_model(cfg).init(gen)
    assert pt.embed.shape == (cfg.vocab_size, cfg.d_model)
    assert pt.embed.dtype == torch.bfloat16
    assert pt.layers[0].attn["wk"].shape == (cfg.d_model,
                                             cfg.n_kv_heads * cfg.head_dim)
    n = sum(p.numel() for p in pt.parameters())
    assert n == cfg.param_count() + cfg.d_model      # + the final norm
    again = tmodel.build_model(cfg).init(
        torch.Generator("cpu").manual_seed(0))
    assert torch.equal(again.layers[-1].mlp["w_down"],
                       pt.layers[-1].mlp["w_down"])


def test_decode_drops_rows_past_the_cache():
    """A row whose position is past a global cache writes nothing there
    (the JAX scatters' mode="drop")."""
    cfg = tbase.reduced(tbase.get_config("yi_6b"), dtype="float32")
    model = tmodel.build_model(cfg)
    pt = model.init(torch.Generator("cpu").manual_seed(0))
    cache = model.init_cache(2, 8, device="cpu")
    tok = torch.tensor([[3], [4]])
    _, cache = model.decode_step(pt, cache, tok, torch.tensor([2, 8]))
    assert cache[0]["k"][0, 2].abs().sum() > 0
    assert cache[0]["k"][1].abs().sum() == 0


def test_unported_arch_and_block_kinds_raise():
    with pytest.raises(ValueError, match="not ported"):
        tbase.get_config("rwkv6_3b")
    with pytest.raises(ValueError, match="not an architecture"):
        tbase.get_config("gpt5")
    base = tbase.reduced(tbase.get_config("yi_6b"))
    for over in (dict(block_pattern=("rwkv",)),
                 dict(block_pattern=("global", "rglru")),
                 dict(n_experts=4, experts_per_token=2)):
        cfg = dataclasses.replace(base, **over)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tmodel.build_model(cfg)
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            kvcache.init_cache(cfg, 1, 8, device="cpu")


def test_attention_impl_is_pinned_or_rejected():
    cfg = tbase.reduced(tbase.get_config("gemma2_9b"), dtype="float32")
    pt = tmodel.build_model(cfg).init(torch.Generator("cpu").manual_seed(0))
    tokens = torch.arange(1, 11)[None]
    a, _ = tmodel.build_model(cfg).prefill(pt, tokens)
    b, _ = tmodel.build_model(cfg, impl="torch").prefill(pt, tokens)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tmodel.build_model(cfg, impl="cuda").prefill(pt, tokens)
    with pytest.raises(ValueError, match="unknown impl"):
        tmodel.build_model(cfg, impl="pallas")
    spec = ttr.attn_spec(cfg, "global")
    q = torch.zeros((1, 4, 4, 32))
    with pytest.raises(NotImplementedError, match="q_offset"):
        layers.blockwise_attention(q, q[:, :, :2], q[:, :, :2], spec=spec,
                                   q_offset=3)
