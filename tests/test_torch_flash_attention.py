"""The port's flash attention on the CPU against the JAX package.

The plain version ``repro_torch.kernels.ref.flash_attention_ref`` (and
``ops.flash_attention`` on CPU tensors, which dispatches to it) is held to
``repro.models.layers.blockwise_attention`` and to the Pallas kernel
``repro.kernels.flash_attention.flash_attention`` in interpret mode, on the
same numpy inputs.  Tolerances are those of the JAX package's own test
(``tests/test_kernels.py``): f32 atol 3e-5 (sums in another order), bf16
atol 2e-2 (one bf16 rounding step of outputs of size about 1).
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
