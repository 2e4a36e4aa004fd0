"""The port's flash attention on the CPU against the JAX package.

The plain version ``repro_torch.kernels.ref.flash_attention_ref`` (and
``ops.flash_attention`` on CPU tensors, which dispatches to it) is held to
``repro.models.layers.blockwise_attention`` and to the Pallas kernel
``repro.kernels.flash_attention.flash_attention`` in interpret mode, on the
same numpy inputs.  Tolerances are those of the JAX package's own test
(``tests/test_kernels.py``): f32 atol 3e-5 (sums in another order), bf16
atol 2e-2 (one bf16 rounding step of outputs of size about 1).

What surrounds the bf16 tensor-core kernel is held here too: its tile plan
against ``repro.models.layers._causal_kv_range``, its TMA geometry, and an
emulation of its arithmetic (64-key tiles, log2-unit online softmax, P
rounded to bf16 before P . V) against ``blockwise_attention``.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as jlayers
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ops, ref

FLASH_CASES = [
    # (B, S, H, KV, D, window, softcap, dtype): tests/test_kernels.py
    (2, 24, 4, 2, 16, 0, 0.0, "float32"),
    (1, 33, 4, 4, 8, 0, 0.0, "float32"),      # MHA + ragged padding
    (2, 24, 4, 2, 16, 7, 0.0, "float32"),     # sliding window
    (2, 24, 4, 2, 16, 0, 30.0, "float32"),    # softcap (gemma2)
    (2, 40, 6, 2, 32, 9, 50.0, "float32"),    # window + softcap + GQA 3
    (2, 32, 4, 2, 16, 0, 0.0, "bfloat16"),
]
EXTRA_CASES = [
    (1, 70, 4, 2, 256, 16, 50.0, "float32"),   # gemma2's head_dim
    (1, 70, 4, 2, 256, 0, 50.0, "bfloat16"),
    (2, 1, 4, 2, 32, 0, 0.0, "float32"),       # Sq = 1
    (1, 1, 2, 1, 256, 4, 50.0, "bfloat16"),
]
TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _inputs(case):
    b, s, h, kv, d, _, _, dtype = case
    rng = np.random.default_rng(b * s + d)
    return [rng.normal(0, 1, shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _jax(case, arrays, *, pallas: bool):
    b, s, h, kv, d, window, cap, dtype = case
    dt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(a, dt) for a in arrays)
    if pallas:
        out = pallas_flash(q, k, v, window=window, softcap=cap, q_chunk=8,
                           kv_chunk=8, interpret=True)
    else:
        spec = jlayers.AttnSpec(n_heads=h, n_kv_heads=kv, head_dim=d,
                                d_model=h * d, window=window, softcap=cap,
                                dtype=dt)
        out = jlayers.blockwise_attention(q, k, v, spec=spec, q_chunk=8,
                                          kv_chunk=8)
    return np.asarray(out.astype(jnp.float32))


def _torch(case, arrays, fn, **kw):
    *_, window, cap, dtype = case
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(dt) for a in arrays)
    out = fn(q, k, v, window=window, softcap=cap, **kw)
    assert out.dtype == dt and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("case", FLASH_CASES + EXTRA_CASES)
def test_plain_flash_matches_jax_blockwise(case):
    arrays = _inputs(case)
    want = _jax(case, arrays, pallas=False)
    got = _torch(case, arrays, ref.flash_attention_ref)
    np.testing.assert_allclose(got, want, atol=TOL[case[-1]], rtol=0)
    # ops on CPU tensors is the plain version, bit for bit
    np.testing.assert_array_equal(_torch(case, arrays, ops.flash_attention),
                                  got)


@pytest.mark.parametrize("case", FLASH_CASES + EXTRA_CASES[:1])
def test_plain_flash_matches_pallas_interpret(case):
    arrays = _inputs(case)
    want = _jax(case, arrays, pallas=True)
    got = _torch(case, arrays, ref.flash_attention_ref)
    np.testing.assert_allclose(got, want, atol=TOL[case[-1]], rtol=0)


def test_plain_flash_query_chunks_do_not_change_the_result():
    case = (1, 70, 4, 2, 32, 9, 50.0, "float32")
    arrays = _inputs(case)
    whole = _torch(case, arrays, ref.flash_attention_ref)
    for q_chunk in (1, 7, 64):
        np.testing.assert_allclose(
            _torch(case, arrays, ref.flash_attention_ref, q_chunk=q_chunk),
            whole, atol=1e-6, rtol=0)


def test_query_scale_takes_the_dtype_first():
    """JAX multiplies q by a weakly typed float: in bf16 the scale rounds
    to bf16 before the product (1/sqrt(32) is not a bf16 number)."""
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (4, 32)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        want = np.asarray((jnp.asarray(x, dtype) * (1.0 / math.sqrt(32)))
                          .astype(jnp.float32))
        got = tflash.scale_query(torch.from_numpy(x).to(getattr(torch, dtype)))
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("shapes,dtype,match", [
    (((1, 4, 2, 12), (1, 4, 2, 12)), torch.float32, "multiple of 8"),
    (((1, 4, 2, 264), (1, 4, 2, 264)), torch.float32, "multiple of 8"),
    (((1, 4, 3, 16), (1, 4, 2, 16)), torch.float32, "multiple of KV"),
    (((1, 5, 2, 16), (1, 4, 2, 16)), torch.float32, "Sq <= Sk"),
    (((1, 4, 2, 16), (1, 4, 2, 16)), torch.float16, "float32 or bfloat16"),
])
def test_flash_rejects_what_the_kernel_does_not_take(shapes, dtype, match):
    q = torch.zeros(shapes[0], dtype=dtype)
    k = torch.zeros(shapes[1], dtype=dtype)
    for fn in (tflash.flash_attention, ref.flash_attention_ref):
        with pytest.raises((ValueError, TypeError), match=match):
            fn(q, k, k)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 4, 2, 16))
    before = tflash.LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tflash.flash_attention(q, q, q)
    assert tflash.LAUNCHES == before


# ---------------------------------------------------------------------------
# The bf16 tensor-core kernel's geometry and arithmetic
# ---------------------------------------------------------------------------

PLAN_S = (1, 63, 64, 65, 127, 128, 129, 1000, 7000)
PLAN_WINDOWS = (0, 7, 100, 4096)


@pytest.mark.parametrize("window", PLAN_WINDOWS)
@pytest.mark.parametrize("s", PLAN_S)
def test_tile_plan_is_the_causal_kv_range(s, window):
    """Every 128-row query tile walks the 64-key tiles that
    ``_causal_kv_range`` gives it, heaviest tiles first, and the plan visits
    every live (q, k) pair exactly once and no dead key tile."""
    plan = tflash.tile_plan(s, s, window)
    spec = jlayers.AttnSpec(n_heads=1, n_kv_heads=1, head_dim=8, d_model=8,
                            window=window)
    nk = -(-s // tflash.BK)
    assert sorted(t[0] for t in plan) == list(range(0, s, tflash.BQ))
    for q0, lo, hi in plan:
        want = jlayers._causal_kv_range(spec, q0 // tflash.BQ, 0, tflash.BQ,
                                        tflash.BK, nk)
        assert (lo, hi) == tuple(int(x) for x in want)
    work = [hi - lo for _, lo, hi in plan]
    assert work == sorted(work, reverse=True)

    # each row lies in one tile; its live keys [first, q] lie in the tile's
    # key range; each key tile of the range holds a live key of some row
    rows = np.zeros(s, np.int64)
    for q0, lo, hi in plan:
        q = np.arange(q0, min(q0 + tflash.BQ, s))
        rows[q] += 1
        first = np.maximum(q - window + 1, 0) if window > 0 else 0 * q
        assert np.all(lo * tflash.BK <= first) and np.all(q < hi * tflash.BK)
        for kt in range(lo, hi):
            k0, k1 = kt * tflash.BK, min((kt + 1) * tflash.BK, s)
            assert np.any((first < k1) & (q >= k0))
    assert np.all(rows == 1)


@pytest.mark.parametrize("d", range(8, tflash.MAX_HEAD_DIM + 1, 8))
def test_tma_geometry_strides_and_shared_memory(d):
    b, sq, sk, h, kv = 2, 1000, 1000, 16, 8
    geo = tflash.tma_geometry(b, sq, sk, h, kv, d)
    assert geo.q_dims == (d, h, sq, b) and geo.kv_dims == (d, kv, sk, b)
    assert geo.q_strides == (2 * d, 2 * h * d, 2 * sq * h * d)
    assert geo.kv_strides == (2 * d, 2 * kv * d, 2 * sk * kv * d)
    assert all(st % 16 == 0 for st in geo.q_strides + geo.kv_strides)
    assert geo.box == (64, 1, 64, 1)
    assert geo.d_pad % 64 == 0 and d <= geo.d_pad < d + 64
    assert geo.grid == (b * h, -(-sq // 128))
    # Q (2 x 64 rows) and a 2-stage K, V ring of 64-key tiles, bf16, plus
    # alignment slack and the barriers, within an H100 block's 227 KB
    tiles = (2 * 64 + 2 * 2 * 64) * geo.d_pad * 2
    assert geo.smem_bytes == tiles + 1024 + 64 <= tflash.MAX_SMEM_BYTES
    if d > 192:
        assert geo.smem_bytes == 197_696      # 193 KB at gemma2's D = 256


@pytest.mark.parametrize("args,match", [
    ((1, 64, 64, 2, 1, 12), "multiple of 8"),
    ((1, 64, 64, 2, 1, 264), "multiple of 8"),
    ((1, 64, 64, 2, 1, 4), "multiple of 8"),
    ((1, 128 * 65_536, 128 * 65_536, 1, 1, 8), "query tiles"),
    ((1, 64, (1 << 32) + 1, 1, 1, 8), "TMA dims"),
    ((1, 64, 1 << 30, 8, 8, 256), "TMA byte strides"),
])
def test_tma_geometry_rejects_what_tma_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        tflash.tma_geometry(*args)


def _emulate_tensor_core_kernel(q, k, v, *, window, softcap):
    """The bf16 kernel's arithmetic on the CPU, tile by tile: f32 logits of
    bf16 inputs, the softcap, logits in log2 units, the finite -1e30 mask,
    an online softmax over the plan's 64-key tiles with exp2, P rounded to
    bf16 before P . V in f32, l summed from the f32 p."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    g = h // kv
    log2e = 1.4426950408889634
    qf = tflash.scale_query(q).float().reshape(b, sq, kv, g, d)
    kf, vf = k.float(), v.float()
    out = torch.empty((b, sq, h, d), dtype=torch.float32)
    for q0, lo, hi in tflash.tile_plan(sq, sk, window):
        q1 = min(q0 + tflash.BQ, sq)
        qt = qf[:, q0:q1].permute(0, 2, 3, 1, 4)       # (B, KV, G, rows, D)
        rows = torch.arange(q0, q1)[:, None]
        m = torch.full(qt.shape[:-1], -1e30)
        l = torch.zeros(qt.shape[:-1])
        acc = torch.zeros(qt.shape)
        for kt in range(lo, hi):
            k0, k1 = kt * tflash.BK, min((kt + 1) * tflash.BK, sk)
            kk = kf[:, k0:k1].permute(0, 2, 1, 3)[:, :, None]
            vv = vf[:, k0:k1].permute(0, 2, 1, 3)[:, :, None]
            x = qt @ kk.transpose(-1, -2)
            if softcap > 0:
                x = torch.tanh(x * (1.0 / softcap)) * (softcap * log2e)
            else:
                x = x * log2e
            cols = torch.arange(k0, k1)[None, :]
            live = rows >= cols
            if window > 0:
                live &= rows - cols < window
            x = torch.where(live, x, torch.tensor(-1e30))
            m_new = torch.maximum(m, x.amax(-1))
            p = torch.exp2(x - m_new[..., None])
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p.bfloat16().float() @ vv
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q1] = o.permute(0, 3, 1, 2, 4).reshape(b, q1 - q0, h, d)
    return out.to(q.dtype)


@pytest.mark.parametrize("case", [
    (1, 1000, 2, 1, 256, 0, 50.0, "bfloat16"),
    (1, 1000, 4, 2, 256, 100, 50.0, "bfloat16"),
    (2, 300, 4, 2, 256, 7, 0.0, "bfloat16"),
    (1, 129, 2, 2, 256, 0, 30.0, "bfloat16"),
    (2, 65, 4, 2, 64, 0, 0.0, "bfloat16"),
])
def test_tensor_core_arithmetic_holds_the_bf16_tolerance(case):
    """P rounded to bf16 before P . V keeps the kernel's design within the
    bf16 2e-2 of the JAX blockwise attention (and of the plain version)."""
    arrays = _inputs(case)
    want = _jax(case, arrays, pallas=False)
    got = _torch(case, arrays, _emulate_tensor_core_kernel)
    np.testing.assert_allclose(got, want, atol=TOL["bfloat16"], rtol=0)
    plain = _torch(case, arrays, ref.flash_attention_ref)
    np.testing.assert_allclose(got, plain, atol=TOL["bfloat16"], rtol=0)
