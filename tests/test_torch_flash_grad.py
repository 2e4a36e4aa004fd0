"""The port's attention gradients on the CPU against the JAX package.

``repro_torch.models.layers.blockwise_attention`` under autograd is the
``_Flash`` Function: on CPU tensors the plain forward with its log-sum-exp
(``ref.flash_attention_fwd_ref``) and the plain backward
(``ref.flash_attention_bwd_ref``).  Both are held, on the same numpy
inputs, to ``jax.vjp`` of ``repro.models.layers.blockwise_attention`` with
16-row chunks (so block edges are crossed), and to torch autograd through a
dense attention.  The plain forward's LSE is held to ``m + log(l)`` of the
JAX ``_flash_fwd``.

The CUDA backward kernels (``csrc/flash_attention_bwd.cu``) cannot run
here; their tile walks are emulated in torch and held to the plain backward:
the f32 scalar kernels' (32 x 32 tiles, their in-kernel live-tile ranges)
and the bf16 tensor-core kernels' (64 x 64 tiles, the wrapper's
``bwd_tile_plans``), the latter also with P and dS rounded to bf16 as its
wgmma operands are.

Tolerances (measured on these cases): f32 atol 2e-5 on gradients up to
about 7 (measured max 4.8e-6: sums in another order); bf16 atol the larger
of 0.02 and 1% of the largest gradient (measured max 0.0039, 0.08% of it:
the output and the gradients each round to bf16, at other places in the two
frameworks).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import scale_query
from repro_torch.models import layers as tlayers

S, D = 100, 32
# (H, KV): GQA groups G = 1, 2, 3
HEADS = [(2, 2), (4, 2), (6, 2)]
WINDOWS = [0, 24]
CAPS = [0.0, 50.0]
CASES = [(h, kv, w, cap, "float32") for h, kv in HEADS for w in WINDOWS
         for cap in CAPS] + [
    (2, 2, 0, 0.0, "bfloat16"), (6, 2, 24, 50.0, "bfloat16"),
    (4, 2, 0, 50.0, "bfloat16")]
F32_ATOL = 2e-5
BF16_ATOL, BF16_REL = 0.02, 0.01
# chip_smoke.py phase 7's gate on the bf16 backward kernel: 1% of the
# largest plain gradient
BWD_BF16_REL = 1e-2


def _ids(case):
    h, kv, w, cap, dt = case
    return f"G{h // kv}-w{w}-cap{int(cap)}-{dt}"


def _inputs(case, b=2):
    h, kv, *_ = case
    rng = np.random.default_rng(h * 100 + kv + case[2])
    return [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((b, S, h, D), (b, S, kv, D), (b, S, kv, D),
                          (b, S, h, D))]


def _jax_grads(case, arrays):
    h, kv, w, cap, dtype = case
    dt = jnp.dtype(dtype)
    q, k, v, do = (jnp.asarray(a, dt) for a in arrays)
    spec = jlayers.AttnSpec(n_heads=h, n_kv_heads=kv, head_dim=D,
                            d_model=h * D, window=w, softcap=cap, dtype=dt)

    def f(q, k, v):
        return jlayers.blockwise_attention(q, k, v, spec=spec, q_chunk=16,
                                           kv_chunk=16)
    out, vjp = jax.vjp(f, q, k, v)
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *vjp(do))]


def _torch_grads(case, arrays):
    h, kv, w, cap, dtype = case
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.from_numpy(a).to(dt) for a in arrays)
    for t in (q, k, v):
        t.requires_grad_(True)
    spec = tlayers.AttnSpec(n_heads=h, n_kv_heads=kv, head_dim=D,
                            d_model=h * D, window=w, softcap=cap, dtype=dt)
    out = tlayers.blockwise_attention(q, k, v, spec=spec)
    assert out.grad_fn is not None and "_Flash" in type(out.grad_fn).__name__
    grads = torch.autograd.grad(out, (q, k, v), do)
    for g, t in zip(grads, (q, k, v)):
        assert g.dtype == dt and g.shape == t.shape
    return [x.detach().float().numpy() for x in (out, *grads)]


def _close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    else:
        tol = max(BF16_ATOL, BF16_REL * np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_attention_grads_match_jax_vjp(case):
    arrays = _inputs(case)
    want = _jax_grads(case, arrays)
    got = _torch_grads(case, arrays)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == w.shape, name
        _close(g, w, case[-1])


def _dense(qs, k, v, window, cap):
    """Attention of pre-scaled q written out whole: autograd's reference."""
    b, sq, h, d = qs.shape
    kv = k.shape[2]
    logits = torch.einsum("bqkgd,bskd->bkgqs", qs.reshape(b, sq, kv, h // kv,
                                                          d), k)
    if cap > 0:
        logits = torch.tanh(logits / cap) * cap
    pos = torch.arange(sq)
    mask = pos[:, None] >= pos[None, :]
    if window > 0:
        mask &= pos[:, None] - pos[None, :] < window
    p = torch.softmax(torch.where(mask, logits, ref.MASKED), -1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v).reshape(b, sq, h, d)


@pytest.mark.parametrize("case", [c for c in CASES if c[-1] == "float32"],
                         ids=_ids)
def test_plain_backward_matches_autograd_of_dense_attention(case):
    h, kv, w, cap, _ = case
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(case))
    qs = scale_query(q).requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)
    want = torch.autograd.grad(_dense(qs, k, v, w, cap), (qs, k, v), do)
    with torch.no_grad():
        out, lse = ref.flash_attention_fwd_ref(qs, k, v, window=w,
                                               softcap=cap)
        for q_chunk, kv_chunk in ((16, 16), (7, 33), (512, 512)):
            got = ref.flash_attention_bwd_ref(
                qs, k, v, out, do, lse, window=w, softcap=cap,
                q_chunk=q_chunk, kv_chunk=kv_chunk)
            for g, t in zip(got, want):
                np.testing.assert_allclose(g.numpy(), t.numpy(),
                                           atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES[:4] + CASES[-3:-2], ids=_ids)
def test_plain_lse_is_jax_m_plus_log_l(case):
    """LSE of ``flash_attention_fwd_ref`` = ``m + log(l)`` of the JAX
    ``_flash_fwd`` stats, natural-log units, softcapped and masked."""
    h, kv, w, cap, dtype = case
    b, g, qc = 2, h // kv, 20
    q, k, v, _ = _inputs(case, b)
    dt = jnp.dtype(dtype)
    spec = jlayers.AttnSpec(n_heads=h, n_kv_heads=kv, head_dim=D,
                            d_model=h * D, window=w, softcap=cap, dtype=dt)
    qj = (jnp.asarray(q, dt).reshape(b, S // qc, qc, kv, g, D)
          * (1.0 / math.sqrt(D))).transpose(1, 0, 2, 3, 4, 5)
    kj = jnp.asarray(k, dt).reshape(b, S // qc, qc, kv, D).transpose(
        1, 0, 2, 3, 4)
    vj = jnp.asarray(v, dt).reshape(b, S // qc, qc, kv, D).transpose(
        1, 0, 2, 3, 4)
    _, m, l = jlayers._flash_fwd(qj, kj, vj, 0, spec=spec, q_chunk=qc,
                                 kv_chunk=qc, sk=S)
    want = np.asarray(m + jnp.log(l))                       # (nq,B,KV,G,qc)
    want = want.transpose(1, 2, 3, 0, 4).reshape(b, h, S)
    tq = scale_query(torch.from_numpy(q).to(getattr(torch, dtype)))
    _, lse = ref.flash_attention_fwd_ref(
        tq, torch.from_numpy(k).to(tq.dtype), torch.from_numpy(v).to(tq.dtype),
        window=w, softcap=cap)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, S)
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=0)


def test_flash_attention_ref_returns_the_lse():
    case = CASES[1]
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(case))
    out = ref.flash_attention_ref(q, k, v, window=0, softcap=50.0)
    out2, lse = ref.flash_attention_ref(q, k, v, window=0, softcap=50.0,
                                        return_lse=True)
    assert torch.equal(out, out2)
    want_out, want_lse = ref.flash_attention_fwd_ref(
        scale_query(q), k, v, window=0, softcap=50.0)
    assert torch.equal(lse, want_lse) and torch.equal(out, want_out)


# --------------------------------------------------------------------------
# the CUDA backward's tile walks, emulated (csrc/flash_attention_bwd.cu)
# --------------------------------------------------------------------------

def _scalar_plans(sq, sk, window):
    """The f32 scalar kernels' walk: 32 x 32 tiles, each range computed in
    the kernel (flash_bwd_dkdv: _q_range; flash_bwd_dq: _causal_kv_range)."""
    t = 32
    nq, nk = -(-sq // t), -(-sk // t)
    kv_plan = [(k0, k0 // t, min((k0 + t + window - 2) // t + 1, nq)
                if window > 0 else nq) for k0 in range(0, sk, t)]
    q_plan = []
    for q0 in range(0, sq, t):
        first = q0 - window + 1
        klo = first // t if window > 0 and first > 0 else 0
        q_plan.append((q0, klo, min((min(q0 + t, sq) - 1) // t + 1, nk)))
    return t, kv_plan, q_plan


def _wgmma_plans(sq, sk, window):
    """The bf16 tensor-core kernels' walk: 64 x 64 tiles, the wrapper's own
    plans (kernels/flash_attention.py: bwd_tile_plans)."""
    kv_plan, q_plan = tflash.bwd_tile_plans(sq, sk, window)
    return tflash.BWD_TILE, kv_plan, q_plan


DESIGNS = {"scalar": _scalar_plans, "wgmma": _wgmma_plans}


def _pair_grads(qs, k, v, do, lse, delta, q0, k0, tile, window, cap):
    """p and dS of one (tile-row, tile-key) tile pair, as the kernels'
    masks; masked pairs are 0."""
    sq, sk = qs.shape[0], k.shape[0]
    qb, dob = qs[q0:q0 + tile], do[q0:q0 + tile]
    kb, vb = k[k0:k0 + tile], v[k0:k0 + tile]
    raw, dp = qb @ kb.T, dob @ vb.T
    t = torch.tanh(raw / cap) if cap > 0 else None
    x = t * cap if cap > 0 else raw
    qp = torch.arange(q0, q0 + qb.shape[0])[:, None]
    kp = torch.arange(k0, k0 + kb.shape[0])[None, :]
    live = (qp >= kp) & (kp < sk) & (qp < sq)
    if window > 0:
        live &= qp - kp < window
    p = torch.where(live, torch.exp(x - lse[q0:q0 + tile, None]), 0.0)
    ds = p * (dp - delta[q0:q0 + tile, None])
    if cap > 0:
        ds = ds * (1 - t * t)
    return p, torch.where(live, ds, 0.0)


def _emulate_kernel_bwd(qs, k, v, o, do, lse, window, cap, design="scalar",
                        bf16_operands=False):
    """One head group of a design's two passes: dK, dV over the plan's live
    query tiles of each key tile (for each head of the group), then dQ over
    the plan's live key tiles of each query tile.  With ``bf16_operands``
    P and dS are rounded to bf16 before their products, as the tensor-core
    kernels round their wgmma A operands; sums stay f32.
    qs, o, do: (Sq, G, D); k, v: (Sk, D); lse: (G, Sq)."""
    sq, g, d = qs.shape
    sk = k.shape[0]
    tile, kv_plan, q_plan = DESIGNS[design](sq, sk, window)
    rnd = ((lambda x: x.to(torch.bfloat16).float()) if bf16_operands
           else (lambda x: x))
    delta = (do * o).sum(-1).T                               # (G, Sq)
    dq, dk, dv = torch.zeros_like(qs), torch.zeros_like(k), torch.zeros_like(v)
    for k0, qlo, qhi in kv_plan:
        for gi in range(g):
            for qt in range(qlo, qhi):
                p, ds = _pair_grads(qs[:, gi], k, v, do[:, gi], lse[gi],
                                    delta[gi], qt * tile, k0, tile, window,
                                    cap)
                rows = slice(qt * tile, qt * tile + p.shape[0])
                dv[k0:k0 + tile] += rnd(p).T @ do[rows, gi]
                dk[k0:k0 + tile] += rnd(ds).T @ qs[rows, gi]
    for q0, klo, khi in q_plan:
        for gi in range(g):
            for kt in range(klo, khi):
                k0 = kt * tile
                _, ds = _pair_grads(qs[:, gi], k, v, do[:, gi], lse[gi],
                                    delta[gi], q0, k0, tile, window, cap)
                dq[q0:q0 + ds.shape[0], gi] += rnd(ds) @ k[k0:k0 + ds.shape[1]]
    return dq, dk, dv


def _walk_case(s, d, window, cap, seed, *, g=3, bf16_inputs=False):
    """Inputs of one head group, the plain backward's gradients on them,
    and the emulation's arguments."""
    rng = np.random.default_rng(seed)
    qs, o, do = (torch.from_numpy(rng.normal(0, 1, (1, s, g, d))
                                  .astype(np.float32)) for _ in range(3))
    k, v = (torch.from_numpy(rng.normal(0, 1, (1, s, 1, d)).astype(np.float32))
            for _ in range(2))
    qs = qs / math.sqrt(d)
    if bf16_inputs:
        qs, k, v, do = (t.to(torch.bfloat16).float() for t in (qs, k, v, do))
    o, lse = ref.flash_attention_fwd_ref(qs, k, v, window=window, softcap=cap)
    want = ref.flash_attention_bwd_ref(qs, k, v, o, do, lse, window=window,
                                       softcap=cap)
    want = [want[0][0], want[1][0, :, 0], want[2][0, :, 0]]
    args = (qs[0], k[0, :, 0], v[0, :, 0], o[0], do[0], lse[0], window, cap)
    return args, want


@pytest.mark.parametrize("s,window,cap", [
    (100, 0, 0.0), (100, 24, 50.0), (97, 40, 0.0), (64, 1, 0.0),
    (33, 100, 30.0), (130, 31, 0.0)])
def test_kernel_tile_walk_matches_plain_backward(s, window, cap):
    """Every live pair is visited exactly once by each pass of the scalar
    kernels' walk: the emulated walk equals the plain backward (which masks
    pair by pair)."""
    args, want = _walk_case(s, D, window, cap, s + window)
    got = _emulate_kernel_bwd(*args, design="scalar")
    for g_, w in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), w.numpy(), atol=F32_ATOL,
                                   rtol=0)


# Ragged S on both sides of the 64-row tiles, windows narrower than a tile,
# across a tile edge and wider than S, softcaps; D of one partly filled
# 64-column box (32, 40), two (128) and four (256).
WGMMA_WALKS = [(s, d, w, cap) for d in (32, 40, 128, 256)
               for s, w, cap in ((1, 0, 0.0), (63, 0, 30.0), (65, 24, 0.0),
                                 (130, 70, 50.0), (200, 0, 0.0))]


def _walk_id(case):
    s, d, w, cap = case
    return f"S{s}-D{d}-w{w}-cap{int(cap)}"


@pytest.mark.parametrize("case", WGMMA_WALKS, ids=_walk_id)
def test_wgmma_tile_walk_matches_plain_backward(case):
    """The tensor-core kernels' walk, from the wrapper's plans: in f32 it
    equals the plain backward, so every live pair is visited exactly once by
    each pass and no dead tile adds anything.  Tolerance F32_ATOL times the
    largest gradient (at least 1): the sums run in another order, and at
    D = 256 gradients reach about 4 (measured at most 1.7e-5 of the largest)."""
    s, d, window, cap = case
    args, want = _walk_case(s, d, window, cap, s + d + window)
    got = _emulate_kernel_bwd(*args, design="wgmma")
    for g_, w in zip(got, want):
        tol = F32_ATOL * max(w.abs().max().item(), 1.0)
        np.testing.assert_allclose(g_.numpy(), w.numpy(), atol=tol, rtol=0)


@pytest.mark.parametrize("design", list(DESIGNS))
@pytest.mark.parametrize("case", WGMMA_WALKS, ids=_walk_id)
def test_bf16_operand_rounding_holds_the_bf16_gate(case, design):
    """P and dS rounded to bf16 as the wgmma A operands, sums in f32, on
    bf16 inputs: within phase 7's bf16 gate, 1% of the largest plain f32
    gradient (chip_smoke.py BWD_BF16_REL), of the plain backward on the same
    inputs in f32.  Measured at most 0.32% of it over these cases, so the
    rounding fits the gate without splitting dS into two bf16 parts."""
    s, d, window, cap = case
    args, want = _walk_case(s, d, window, cap, 7 * s + d, bf16_inputs=True)
    got = _emulate_kernel_bwd(*args, design=design, bf16_operands=True)
    for g_, w in zip(got, want):
        tol = BWD_BF16_REL * max(w.abs().max().item(), 1.0)
        np.testing.assert_allclose(g_.numpy(), w.numpy(), atol=tol, rtol=0)


def test_bwd_tile_plans_are_the_reference_ranges():
    """The dK/dV plan's query-tile range of each key tile is the JAX
    ``_q_range`` at 64 x 64 chunks (empty past the last row), the dQ plan is
    ``tile_plan`` at 64-row tiles (``_causal_kv_range``); both heaviest
    first, each tile once."""
    t = tflash.BWD_TILE
    for sq, sk, window in ((1, 1, 0), (200, 200, 0), (300, 300, 70),
                           (4096, 4096, 1024), (100, 230, 0), (129, 129, 1)):
        kv_plan, q_plan = tflash.bwd_tile_plans(sq, sk, window)
        nq = -(-sq // t)
        assert sorted(p[0] for p in kv_plan) == list(range(0, sk, t))
        for k0, lo, hi in kv_plan:
            want_lo = k0 // t
            want_hi = (min((k0 + t + window - 2) // t + 1, nq) if window > 0
                       else nq)
            assert (lo, hi) == ((want_lo, want_hi) if want_lo < nq
                                else (nq, nq))
        work = [hi - lo for _, lo, hi in kv_plan]
        assert work == sorted(work, reverse=True)
        assert q_plan == tflash.tile_plan(sq, sk, window, bq=t)


@pytest.mark.parametrize("d_pad", [64, 128, 192, 256])
def test_bwd_shared_memory_fits_an_h100_block(d_pad):
    """The tensor-core backward's shared memory: K, V (dK/dV) or Q, dO (dQ)
    resident, a 2-stage ring of the two others, 64 x d_pad bf16 tiles, 1 KB
    of alignment slack and the barriers; dK/dV also the 16 KB exchange."""
    dkdv, dq = tflash.bwd_smem_bytes(d_pad)
    tiles = 6 * 64 * d_pad * 2
    assert dq == tiles + 1024 + 64
    assert dkdv == dq + 32 * 128 * 4 <= tflash.MAX_SMEM_BYTES
    if d_pad == 256:
        assert (dkdv, dq) == (214_080, 197_696)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    qs = torch.zeros((1, 8, 2, 16))
    lse = torch.zeros((1, 2, 8))
    before = (tflash.LAUNCHES_BWD, dict(tflash.LAUNCHES_BWD_BY_DTYPE))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_attention_bwd(qs, qs, qs, qs, qs, lse)
    with pytest.raises(ValueError, match="lse must be"):
        tflash.flash_attention_bwd(qs, qs, qs, qs, qs, lse[..., :4])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_attention_fwd(qs, qs, qs, with_lse=True)
    assert (tflash.LAUNCHES_BWD, tflash.LAUNCHES_BWD_BY_DTYPE) == before


def test_attention_under_no_grad_is_the_serving_path():
    """Without autograd (serving) the plain forward runs as before: no
    _Flash node, and the same values as the differentiable path."""
    case = CASES[5]
    h, kv, w, cap, _ = case
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(case))
    spec = tlayers.AttnSpec(n_heads=h, n_kv_heads=kv, head_dim=D,
                            d_model=h * D, window=w, softcap=cap)
    with torch.no_grad():
        served = tlayers.blockwise_attention(q, k, v, spec=spec)
    assert served.grad_fn is None
    trained = tlayers.blockwise_attention(q.requires_grad_(), k, v,
                                          spec=spec, impl="torch")
    assert torch.equal(served, trained.detach())
