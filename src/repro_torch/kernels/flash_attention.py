"""Wrapper of the CUDA flash-attention forward (``csrc/flash_attention.cu``).

Replaces the JAX package's Pallas ``flash_attention``: the same layout
``(B, Sq, H, D)`` for q and the output and ``(B, Sk, KV, D)`` for k and v,
and the same signature.  q is scaled by ``1/sqrt(D)`` in its own dtype
before the launch, as the JAX function does before its ``pallas_call``.
CUDA tensors only; the plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

# Launches of the kernel in this process (the main path's proof of use).
LAUNCHES = 0

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float,
             _P]


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    lib.flash_attention_launch.argtypes = _ARGTYPES
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_error.argtypes = [ctypes.c_int]
    lib.flash_attention_error.restype = ctypes.c_char_p
    return lib


def scale_query(q: torch.Tensor) -> torch.Tensor:
    """``q * (1 / sqrt(D))`` in q's dtype, the scale first rounded to that
    dtype: JAX multiplies by a weakly typed Python float, which takes the
    array's dtype."""
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype)
    return q * scale


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 window: int, softcap: float) -> None:
    """What the kernel takes; raises on anything else."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Sq, H, D) and k, v (B, Sk, KV, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, sk, kv, dk = k.shape
    if k.shape[0] != b or dk != d:
        raise ValueError(f"k and v must be ({b}, Sk, KV, {d}), got "
                         f"{tuple(k.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM}, got {d}")
    if kv < 1 or h % kv:
        raise ValueError(f"H = {h} query heads must be a multiple of KV = "
                         f"{kv}")
    if sk < 1 or sq > sk:
        raise ValueError(f"needs 1 <= Sk and Sq <= Sk (every query row sees "
                         f"its own key), got Sq = {sq}, Sk = {sk}")
    if window < 0 or softcap < 0:
        raise ValueError(f"window and softcap must be >= 0, got {window}, "
                         f"{softcap}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """(B, Sq, H, D) causal attention of q (B, Sq, H, D) over k, v
    (B, Sk, KV, D), with an optional sliding ``window`` (0: none) and tanh
    logit ``softcap`` (0: none); float32 or bfloat16, output in q's dtype.

    k and v are made contiguous if they are not (a copy); the scaled q is a
    new tensor.  Nothing is transposed: the kernel reads the JAX layout.
    """
    global LAUNCHES
    check_shapes(q, k, v, window=window, softcap=softcap)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"the CUDA flash attention takes CUDA tensors, got "
                         f"{q.device}, {k.device}, {v.device}")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    qs = scale_query(q).contiguous()
    k, v = k.contiguous(), v.contiguous()
    for t in (qs, k, v):
        if t.data_ptr() % 16:
            raise ValueError("q, k and v must start on a 16-byte boundary")
    out = torch.empty_like(qs)
    if b == 0 or sq == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, sq, sk, h, kv, d, int(window),
            float(softcap), stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error(err).decode())
    LAUNCHES += 1
    return out
