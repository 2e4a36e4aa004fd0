"""The port's other LM architectures on the CPU against the JAX package.

Reduced configs (``reduced()``: d_model 128, 4 heads, window 64) of the
six architectures the port took over last: musicgen_medium (MHA,
layernorm, sinusoidal positions, GELU), llava_next_34b (8 frontend
embeddings early-fused), phi35_moe (4 experts, top-2), llama4_scout (top-1
and a shared expert), recurrentgemma_2b (RG-LRU and local attention) and
rwkv6_3b (RWKV-6), all in f32, and phi35_moe and recurrentgemma_2b in
bf16.  The JAX ``transformer.init`` weights are carried across by
``params_from_jax``; both packages then run the same numpy tokens (and
frontend embeddings): forward hidden states and cache entries, prefill
logits and caches, and 6 teacher-forced ``decode_step``s with per-row
positions (rows at S and S - 5).  Prompts pass the window (80 tokens) and,
for rwkv6_3b, span two 128-token chunks (256 tokens).

Tolerances (measured on these cases), each times max(1, the largest
reference value): f32 atol 2e-5 (measured at most 8.8e-6 on values up to
about 5; the rwkv state reaches 240, measured 7.6e-5 there, 3.3e-7 of
it); bf16 atol 0.1 (the dense stacks' bound in ``tests/test_torch_lm.py``;
measured at most 0.082, bf16 rounds at other places in the two
frameworks).  Unit parts exact where the arithmetic is the same: the
capacity, the routing (``top_e``, ``sel_idx``) and the frontend draws;
``rglru_scan`` against a loop in float64 atol 1e-12.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.models import frontends as jfront
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro.models import transformer as jtr
from repro_torch.configs import base as tbase
from repro_torch.models import frontends as tfront
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import rglru as trglru
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import transformer as ttr

NEW_ARCHS = ("musicgen_medium", "llava_next_34b", "phi35_moe",
             "llama4_scout", "recurrentgemma_2b", "rwkv6_3b")
# (arch, dtype, prompt length)
CASES = {f"{a}_f32": (a, "float32", 256 if a == "rwkv6_3b" else 80)
         for a in NEW_ARCHS}
CASES.update(phi35_moe_bf16=("phi35_moe", "bfloat16", 80),
             recurrentgemma_2b_bf16=("recurrentgemma_2b", "bfloat16", 80))
TOL = {"float32": 2e-5, "bfloat16": 0.1}
BATCH, DECODE_STEPS, BACK = 2, 6, 5


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close(got, want, dtype):
    want = _np(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(_np(got), want, atol=TOL[dtype] * scale,
                               rtol=0)


def _configs(arch, dtype="float32", **over):
    return (jbase.reduced(jbase.get_config(arch), dtype=dtype, **over),
            tbase.reduced(tbase.get_config(arch), dtype=dtype, **over))


def _port(pj, ct):
    return ttr.params_from_jax(jax.tree.map(np.asarray, pj), ct,
                               device="cpu")


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request):
    """Both packages over one case; everything the tests compare."""
    arch, dtype, s = CASES[request.param]
    cj, ct = _configs(arch, dtype)
    pj = jtr.init(jax.random.key(0), cj)
    pt = _port(pj, ct)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, cj.vocab_size, (BATCH, s)).astype(np.int32)
    fe_j = jfront.fake_frontend_embeds(cj, BATCH)
    fe_t = tfront.fake_frontend_embeds(ct, BATCH, device="cpu")
    out = dict(case=request.param, dtype=dtype, cj=cj, ct=ct, s=s)
    out["fwd_j"] = jtr.forward(pj, cj, jnp.asarray(tokens), fe_j,
                               capture_cache=True, remat=False)
    out["fwd_t"] = pt(torch.as_tensor(tokens), fe_t, capture_cache=True)
    max_seq = s + 16
    lj, cache_j = jmodel.build_model(cj).prefill(
        pj, jnp.asarray(tokens), fe_j, max_seq=max_seq)
    lt, cache_t = tmodel.build_model(ct).prefill(
        pt, torch.as_tensor(tokens), fe_t, max_seq=max_seq)
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


def _entry_keys(kind):
    return {"rwkv": {"state", "tm_prev", "cm_prev"},
            "rglru": {"h", "conv"}}.get(kind, {"k", "v"})


def test_forward_hidden_states_equal_jax(run):
    (xj, _, _), (xt, _) = run["fwd_j"], run["fwd_t"]
    assert tuple(xt.shape) == xj.shape
    _close(xt, xj, run["dtype"])


def test_forward_cache_entries_equal_jax(run):
    (_, ej, _), (_, et) = run["fwd_j"], run["fwd_t"]
    ct = run["ct"]
    assert len(et) == len(ej) == ct.n_layers
    for i, (a, b) in enumerate(zip(ej, et)):
        assert set(a) == set(b) == _entry_keys(ct.block_kind(i))
        for k in a:
            assert tuple(b[k].shape) == a[k].shape, (i, k)
            _close(b[k], a[k], run["dtype"])


def test_prefill_logits_and_cache_equal_jax(run):
    lj, lt, cache_j, cache_t = run["prefill"]
    assert tuple(lt.shape) == lj.shape == (BATCH, run["ct"].vocab_size)
    _close(lt, lj, run["dtype"])
    for a, b in zip(cache_j, cache_t):
        assert set(a) == set(b)
        for k in a:
            assert tuple(b[k].shape) == a[k].shape
            assert str(b[k].dtype)[6:] == str(a[k].dtype), k
            _close(b[k], a[k], run["dtype"])


def test_teacher_forced_decode_equals_jax(run):
    steps, cache_j, cache_t = run["decode"]
    for a, b in steps:
        assert tuple(b.shape) == a.shape
        _close(b, a, run["dtype"])
    for a, b in zip(cache_j, cache_t):
        for k in a:
            _close(b[k], a[k], run["dtype"])


# --------------------------------------------------------------------------
# part 0: each leaf keeps its JAX dtype
# --------------------------------------------------------------------------

F32_LEAVES = {"phi35_moe": ("moe.router",),
              "recurrentgemma_2b": ("rec.ba", "rec.bx", "rec.log_lambda"),
              "rwkv6_3b": ("tm.w0", "tm.wa", "tm.wb", "tm.u",
                           "tm.ln_out_scale")}


@pytest.mark.parametrize("arch", sorted(F32_LEAVES))
def test_bf16_models_keep_the_f32_leaves(arch):
    """Under a bf16 config, ``params_from_jax`` and ``init`` keep the
    leaves the JAX init makes in f32 in f32, each with the JAX leaf's
    values, and every other leaf in bf16."""
    cj, ct = _configs(arch, "bfloat16")
    pj = jtr.init(jax.random.key(0), cj)
    carried = _port(pj, ct)
    drawn = tmodel.build_model(ct).init(torch.Generator("cpu").manual_seed(0))
    want = F32_LEAVES[arch]
    for pt in (carried, drawn):
        for name, leaf in pt.named_parameters():
            f32 = name.split(".", 2)[-1] in want
            assert leaf.dtype == (torch.float32 if f32 else torch.bfloat16), \
                name
    layer0 = jtr.layer_params(pj, cj, 0)
    for path in want:
        part, leaf = path.split(".")
        got = dict(carried.layers[0].named_parameters())[path]
        np.testing.assert_array_equal(_np(got), np.asarray(layer0[part][leaf]))


def test_bf16_routing_equals_jax():
    """The port's routing of a bf16 phi35_moe layer (router carried in
    f32) picks the JAX model's experts and tokens; a router rounded to bf16
    would not (the last assert: the repair is needed)."""
    cj, ct = _configs("phi35_moe", "bfloat16")
    pj = jtr.init(jax.random.key(0), cj)
    router = dict(_port(pj, ct).layers[0].named_parameters())["moe.router"]
    xf = np.random.default_rng(3).normal(0, 1, (512, cj.d_model))
    xj = jnp.asarray(xf, jnp.bfloat16)
    spec_j = jtr.moe_spec(cj)
    logits = xj.astype(jnp.float32) @ layer_router(pj, cj)
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, spec_j.experts_per_token)
    gate = jnp.zeros(probs.shape, jnp.float32).at[
        jnp.arange(xf.shape[0])[:, None], top_e].set(
            top_p / jnp.sum(top_p, -1, keepdims=True))
    _, sel_idx = jax.lax.top_k(gate.T, jmoe.capacity(xf.shape[0], spec_j))
    xt = torch.as_tensor(xf).to(torch.bfloat16)
    spec_t = ttr.moe_spec(ct)
    _, te, _, si = tmoe.route({"router": router}, xt, spec_t)
    np.testing.assert_array_equal(te.numpy(), np.asarray(top_e))
    np.testing.assert_array_equal(si.numpy(), np.asarray(sel_idx))
    rounded = router.detach().to(torch.bfloat16).float()
    _, te_bf16, _, _ = tmoe.route({"router": rounded}, xt, spec_t)
    assert not np.array_equal(te_bf16.numpy(), np.asarray(top_e))


def layer_router(pj, cj):
    return jtr.layer_params(pj, cj, 0)["moe"]["router"]


# --------------------------------------------------------------------------
# MoE units
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["phi35_moe", "llama4_scout"])
def test_capacity_equals_jax(arch):
    for cfg in (jbase.get_config(arch), jbase.reduced(jbase.get_config(arch))):
        spec_j = jtr.moe_spec(cfg)
        spec_t = ttr.moe_spec(tbase.get_config(arch) if cfg.d_model > 128
                              else tbase.reduced(tbase.get_config(arch)))
        for t in (1, 4, 7, 8, 9, 33, 100, 1152, 4096, 4097):
            assert tmoe.capacity(t, spec_t) == jmoe.capacity(t, spec_j), t


def test_equal_gates_overflow_keeps_the_lowest_indices():
    """reduced llama4_scout (4 experts, top-1, a shared expert): every
    token routed to expert 0 with gate exactly 1.0; the expert keeps its
    capacity's lowest-index tokens, as ``jax.lax.top_k`` does, the empty
    experts' zero scores tie to the lowest indices too, and the output
    equals the JAX layer's."""
    cj, ct = _configs("llama4_scout")
    spec_j, spec_t = jtr.moe_spec(cj), ttr.moe_spec(ct)
    pj = jmoe.moe_init(jax.random.key(0), spec_j)
    router = np.zeros((cj.d_model, cj.n_experts), np.float32)
    router[:, 0] = 1.0
    pj = dict(pj, router=jnp.asarray(router))
    rng = np.random.default_rng(0)
    x = np.abs(rng.normal(0, 1, (2, 16, cj.d_model))).astype(np.float32)
    t = x.shape[0] * x.shape[1]
    c = tmoe.capacity(t, spec_t)
    assert c < t                                   # expert 0 overflows
    pt = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), pj)
    _, top_e, score, idx = tmoe.route(pt, torch.as_tensor(x).reshape(t, -1),
                                      spec_t)
    assert bool((top_e == 0).all())
    assert torch.equal(score[0], torch.ones(c))
    assert torch.equal(idx, torch.arange(c).expand(cj.n_experts, c))
    out_j, aux_j = jmoe.moe_apply(pj, jnp.asarray(x), spec_j)
    out_t, aux_t = tmoe.moe_apply(pt, torch.as_tensor(x), spec_t)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=2e-5,
                               rtol=0)
    for k in ("moe_aux", "moe_dropped"):
        assert float(aux_t[k]) == pytest.approx(float(aux_j[k]), abs=1e-6)
    assert float(aux_t["moe_dropped"]) == 1.0 - c / (cj.n_experts * c)


# --------------------------------------------------------------------------
# RG-LRU, RWKV and frontend units
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seq", [1, 2, 3, 7, 64, 100])
def test_rglru_scan_equals_a_sequential_loop(seq):
    rng = np.random.default_rng(seq)
    a = torch.as_tensor(rng.uniform(0, 1, (2, seq, 5)))
    b = torch.as_tensor(rng.normal(0, 1, (2, seq, 5)))
    h = torch.zeros((2, 5), dtype=torch.float64)
    want = []
    for t in range(seq):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = trglru.rglru_scan(a, b)
    torch.testing.assert_close(got, torch.stack(want, 1), atol=1e-12, rtol=0)
    jgot = jrglru.rglru_scan(jnp.asarray(a.numpy(), jnp.float32),
                             jnp.asarray(b.numpy(), jnp.float32))
    np.testing.assert_allclose(np.asarray(jgot), got.numpy(), atol=1e-5)


@pytest.mark.parametrize("seq,ok", [(1, True), (100, True), (128, True),
                                    (200, False), (256, True), (300, False)])
def test_rwkv_chunk_refusal_matches_jax(seq, ok):
    """A sequence longer than the 128-token chunk must be a multiple of it
    in both packages (the JAX package asserts, the port raises)."""
    cj, ct = _configs("rwkv6_3b")
    spec_j = jtr.rwkv_spec(cj)
    pj = jrwkv.rwkv_init(jax.random.key(0), spec_j)
    pt = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), pj)
    x = np.random.default_rng(0).normal(0, 1, (1, seq, cj.d_model)).astype(
        np.float32)
    if ok:
        want = jrwkv.time_mix(pj, spec_j, jnp.asarray(x))
        got = trwkv.time_mix(pt, ttr.rwkv_spec(ct), torch.as_tensor(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    else:
        with pytest.raises(AssertionError):
            jrwkv.time_mix(pj, spec_j, jnp.asarray(x))
        with pytest.raises(ValueError, match="multiple"):
            trwkv.time_mix(pt, ttr.rwkv_spec(ct), torch.as_tensor(x))


@pytest.mark.parametrize("arch", NEW_ARCHS + ("gemma2_9b",))
def test_frontend_stubs_equal_jax(arch):
    cj, ct = _configs(arch, "bfloat16")
    for full in (False, True):
        j, t = (jbase.get_config(arch), tbase.get_config(arch)) if full \
            else (cj, ct)
        spec_j = jfront.frontend_embeds_spec(j, 3)
        spec_t = tfront.frontend_embeds_spec(t, 3)
        if spec_j is None:
            assert spec_t is None
            assert tfront.fake_frontend_embeds(t, 3, device="cpu") is None
            continue
        assert spec_t == (spec_j.shape, torch.bfloat16)
    if not ct.frontend_tokens:
        return
    for seed in (0, 5):
        want = jfront.fake_frontend_embeds(cj, 3, seed)
        got = tfront.fake_frontend_embeds(ct, 3, seed, device="cpu")
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(got), _np(want))
    labels = np.arange(3 * 20, dtype=np.int32).reshape(3, 20)
    np.testing.assert_array_equal(
        tfront.mask_frontend_labels(ct, torch.as_tensor(labels)).numpy(),
        np.asarray(jfront.mask_frontend_labels(cj, jnp.asarray(labels))))


def test_frontend_needs_room_for_its_positions():
    _, ct = _configs("llava_next_34b")
    pt = tmodel.build_model(ct).init(torch.Generator("cpu").manual_seed(0))
    fe = tfront.fake_frontend_embeds(ct, 1, device="cpu")
    with pytest.raises(ValueError, match="frontend positions"):
        pt(torch.ones((1, ct.frontend_tokens - 1), dtype=torch.long), fe)
    x, _ = pt(torch.ones((1, ct.frontend_tokens), dtype=torch.long), fe)
    y, _ = pt(torch.ones((1, ct.frontend_tokens), dtype=torch.long))
    assert not torch.equal(x, y)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the repeat is of the card's "
                    "index_add")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["phi35_moe", "llama4_scout"])
def test_moe_combine_repeats_bitwise_on_the_card(dev, arch):
    """The gate-weighted index_add adds at most two non-zero values a
    token, so two runs give the same bits whatever order the device adds
    in."""
    _, ct = _configs(arch, "bfloat16", d_model=512, d_ff=1024)
    spec = ttr.moe_spec(ct)
    gen = torch.Generator(dev).manual_seed(0)
    p = tmoe.moe_init(gen, spec)
    x = torch.randn((2, 2048, ct.d_model), generator=gen, device=dev).to(
        torch.bfloat16)
    first, _ = tmoe.moe_apply(p, x, spec)
    for _ in range(3):
        again, _ = tmoe.moe_apply(p, x, spec)
        assert torch.equal(first, again)
