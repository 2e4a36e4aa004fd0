"""The port's attention gradients on the CPU against the JAX package.

``repro_torch.models.layers.blockwise_attention`` under autograd is the
``_Flash`` Function: on CPU tensors the plain forward with its log-sum-exp
(``ref.flash_attention_fwd_ref``) and the plain backward
(``ref.flash_attention_bwd_ref``).  Both are held, on the same numpy
inputs, to ``jax.vjp`` of ``repro.models.layers.blockwise_attention`` with
16-row chunks (so block edges are crossed), and to torch autograd through a
dense attention.  The plain forward's LSE is held to ``m + log(l)`` of the
JAX ``_flash_fwd``.

The CUDA backward kernel (``csrc/flash_attention_bwd.cu``) cannot run here;
its tile walk is emulated in torch (32 x 32 tiles, the kernel's live-tile
ranges) and held to the plain backward.

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
# the CUDA backward's tile walk, emulated (csrc/flash_attention_bwd.cu)
# --------------------------------------------------------------------------

BQ = BKV = 32


def _pair_grads(qs, k, v, do, lse, delta, q0, k0, window, cap):
    """p and dS of one (32-row, 32-key) tile pair, as the kernel's
    ``grad_logit`` and ``live_pair``; masked pairs are 0."""
    sq, sk = qs.shape[0], k.shape[0]
    qb, dob = qs[q0:q0 + BQ], do[q0:q0 + BQ]
    kb, vb = k[k0:k0 + BKV], v[k0:k0 + BKV]
    raw, dp = qb @ kb.T, dob @ vb.T
    t = torch.tanh(raw / cap) if cap > 0 else None
    x = t * cap if cap > 0 else raw
    qp = torch.arange(q0, q0 + qb.shape[0])[:, None]
    kp = torch.arange(k0, k0 + kb.shape[0])[None, :]
    live = (qp >= kp) & (kp < sk) & (qp < sq)
    if window > 0:
        live &= qp - kp < window
    p = torch.where(live, torch.exp(x - lse[q0:q0 + BQ, None]), 0.0)
    ds = p * (dp - delta[q0:q0 + BQ, None])
    if cap > 0:
        ds = ds * (1 - t * t)
    return p, torch.where(live, ds, 0.0)


def _emulate_kernel_bwd(qs, k, v, o, do, lse, window, cap):
    """One head group of the kernel's passes: dK, dV over the live query
    tiles of each key tile, then dQ over the live key tiles of each query
    tile, with the kernel's range formulas (flash_bwd_dkdv, flash_bwd_dq).
    qs, o, do: (Sq, G, D); k, v: (Sk, D); lse: (G, Sq)."""
    sq, g, d = qs.shape
    sk = k.shape[0]
    delta = (do * o).sum(-1).T                               # (G, Sq)
    dq, dk, dv = torch.zeros_like(qs), torch.zeros_like(k), torch.zeros_like(v)
    nq, nk = -(-sq // BQ), -(-sk // BKV)
    for kt in range(nk):
        k0 = kt * BKV
        qlo = k0 // BQ
        qhi = min((k0 + BKV + window - 2) // BQ + 1, nq) if window > 0 else nq
        for gi in range(g):
            for qt in range(qlo, qhi):
                p, ds = _pair_grads(qs[:, gi], k, v, do[:, gi], lse[gi],
                                    delta[gi], qt * BQ, k0, window, cap)
                rows = slice(qt * BQ, qt * BQ + p.shape[0])
                dv[k0:k0 + BKV] += p.T @ do[rows, gi]
                dk[k0:k0 + BKV] += ds.T @ qs[rows, gi]
    for gi in range(g):
        for qt in range(nq):
            q0 = qt * BQ
            nvq = min(BQ, sq - q0)
            khi = min((q0 + nvq - 1) // BKV + 1, nk)
            first = q0 - window + 1
            klo = first // BKV if window > 0 and first > 0 else 0
            for kt in range(klo, khi):
                _, ds = _pair_grads(qs[:, gi], k, v, do[:, gi], lse[gi],
                                    delta[gi], q0, kt * BKV, window, cap)
                dq[q0:q0 + nvq, gi] += ds @ k[kt * BKV:kt * BKV + ds.shape[1]]
    return dq, dk, dv


@pytest.mark.parametrize("s,window,cap", [
    (100, 0, 0.0), (100, 24, 50.0), (97, 40, 0.0), (64, 1, 0.0),
    (33, 100, 30.0), (130, 31, 0.0)])
def test_kernel_tile_walk_matches_plain_backward(s, window, cap):
    """Every live pair is visited exactly once by each pass: the emulated
    tile walk equals the plain backward (which masks pair by pair)."""
    rng = np.random.default_rng(s + window)
    g = 3
    qs, o, do = (torch.from_numpy(rng.normal(0, 1, (1, s, g, D))
                                  .astype(np.float32)) for _ in range(3))
    k, v = (torch.from_numpy(rng.normal(0, 1, (1, s, 1, D)).astype(np.float32))
            for _ in range(2))
    qs = qs / math.sqrt(D)
    o, lse = ref.flash_attention_fwd_ref(qs, k, v, window=window, softcap=cap)
    want = ref.flash_attention_bwd_ref(qs, k, v, o, do, lse, window=window,
                                       softcap=cap)
    got = _emulate_kernel_bwd(qs[0], k[0, :, 0], v[0, :, 0], o[0], do[0],
                              lse[0], window, cap)
    np.testing.assert_allclose(got[0].numpy(), want[0][0].numpy(),
                               atol=F32_ATOL, rtol=0)
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), want[i][0, :, 0].numpy(),
                                   atol=F32_ATOL, rtol=0)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    from repro_torch.kernels import flash_attention as tflash
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
