"""Wrapper of the CUDA flash-attention forward (``csrc/flash_attention.cu``).

Replaces the JAX package's Pallas ``flash_attention``: the same layout
``(B, Sq, H, D)`` for q and the output and ``(B, Sk, KV, D)`` for k and v,
and the same signature.  q is scaled by ``1/sqrt(D)`` in its own dtype
before the launch, as the JAX function does before its ``pallas_call``.
Each dtype has one kernel and no fallback to the other: bfloat16 goes to
the tensor-core kernel (wgmma + TMA), float32 to the scalar one.  CUDA
tensors only; the plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.

The tensor-core kernel's geometry is computed here, in Python the CPU tests
reach: :func:`tile_plan` (the live KV tiles of each query tile, heaviest
first) and :func:`tma_geometry` (the tensor maps' dims, byte strides and
box, the grid and the shared memory), both passed to the launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from dataclasses import dataclass

import torch

from repro_torch.kernels import _build

# Launches of the kernels in this process (the main path's proof of use):
# all of them, and by dtype (bfloat16: tensor-core kernel, float32: scalar).
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"bfloat16": 0, "float32": 0}
# Launches from several threads: _LAUNCH_LOCK makes each kernel's
# shared-memory opt-in (set before every launch) and its launch one step, so
# another thread's lower opt-in cannot land between them; _COUNT_LOCK keeps
# the counts exact.
_LAUNCH_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256

# The tensor-core kernel's tiles: 128 query rows a block (two warpgroups of
# 64), 64 keys a KV tile, every tile cut into 64 x 64 bf16 boxes (8 KB).
BQ = 128
BK = 64
BOX = (64, 1, 64, 1)
PANEL_BYTES = 64 * 64 * 2
STAGES = 2
MAX_SMEM_BYTES = 232_448           # what an H100 block can use
# TMA's limits (cuTensorMapEncodeTiled): dims up to 2^32, byte strides
# multiples of 16 below 2^40; grid.y of the launch up to 65,535 tiles.
_TMA_MAX_DIM = 1 << 32
_TMA_MAX_STRIDE = 1 << 40
_MAX_GRID_Y = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U64 = ctypes.POINTER(ctypes.c_uint64)
_U32 = ctypes.POINTER(ctypes.c_uint32)
_F32_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P]
_BF16_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                  _U64, _U64, _U64, _U64, _U32, _I, _I, _P]


def _lib() -> ctypes.CDLL:
    lib = _build.library("flash_attention")
    lib.flash_attention_f32_launch.argtypes = _F32_ARGTYPES
    lib.flash_attention_f32_launch.restype = ctypes.c_int
    lib.flash_attention_bf16_launch.argtypes = _BF16_ARGTYPES
    lib.flash_attention_bf16_launch.restype = ctypes.c_int
    lib.flash_attention_error.argtypes = [ctypes.c_int]
    lib.flash_attention_error.restype = ctypes.c_char_p
    return lib


def tile_plan(sq: int, sk: int, window: int) -> list[tuple[int, int, int]]:
    """``(q0, lo, hi)`` for every 128-row query tile: the live 64-key tiles
    ``[lo, hi)`` of ``repro.models.layers._causal_kv_range`` (q_offset 0;
    the last row capped at ``sq - 1``), heaviest tiles first (later tiles
    first among equals)."""
    nk = -(-sk // BK)
    plan = []
    for q0 in range(0, sq, BQ):
        hi = min((min(q0 + BQ, sq) - 1) // BK + 1, nk)
        lo = max((q0 - window + 1) // BK, 0) if window > 0 else 0
        plan.append((q0, lo, hi))
    return sorted(plan, key=lambda t: (t[1] - t[2], -t[0]))


@dataclass(frozen=True)
class TmaGeometry:
    """What the bf16 launch is given.  Dims innermost first and byte
    strides of dims 1-3, as ``cuTensorMapEncodeTiled`` takes them."""
    q_dims: tuple[int, int, int, int]          # (D, H, Sq, B)
    q_strides: tuple[int, int, int]
    kv_dims: tuple[int, int, int, int]         # (D, KV, Sk, B)
    kv_strides: tuple[int, int, int]
    box: tuple[int, int, int, int]
    d_pad: int                                 # D rounded up to 64
    grid: tuple[int, int]                      # (B * H, query tiles)
    smem_bytes: int


def tma_geometry(b: int, sq: int, sk: int, h: int, kv: int, d: int,
                 ) -> TmaGeometry:
    """The tensor maps over q (B, Sq, H, D) and k, v (B, Sk, KV, D) in bf16
    and the launch shape; raises on what TMA or the kernel cannot take."""
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must be a multiple of 8 up to "
                         f"{MAX_HEAD_DIM} (16-byte TMA strides), got {d}")
    size = 2
    q_dims = (d, h, sq, b)
    kv_dims = (d, kv, sk, b)
    q_strides = (d * size, h * d * size, sq * h * d * size)
    kv_strides = (d * size, kv * d * size, sk * kv * d * size)
    for dim in q_dims + kv_dims:
        if not 1 <= dim <= _TMA_MAX_DIM:
            raise ValueError(f"TMA dims must lie in [1, 2^32], got "
                             f"{q_dims}, {kv_dims}")
    for st in q_strides + kv_strides:
        if st % 16 or st >= _TMA_MAX_STRIDE:
            raise ValueError(f"TMA byte strides must be multiples of 16 "
                             f"below 2^40, got {q_strides}, {kv_strides}")
    tiles = -(-sq // BQ)
    if tiles > _MAX_GRID_Y:
        raise ValueError(f"Sq = {sq} needs {tiles} query tiles, more than "
                         f"the grid's {_MAX_GRID_Y}")
    d_pad = -(-d // 64) * 64
    smem = 1024 + (2 + 2 * STAGES) * (d_pad // 64) * PANEL_BYTES + 64
    assert smem <= MAX_SMEM_BYTES, smem
    return TmaGeometry(q_dims, q_strides, kv_dims, kv_strides, BOX, d_pad,
                       (b * h, tiles), smem)


@functools.lru_cache(maxsize=256)
def _plan_tensor(sq: int, sk: int, window: int, device: torch.device
                 ) -> torch.Tensor:
    """The plan on the card, made once per shape; the copy from pinned
    memory is queued on the stream, so a new prompt length does not wait
    for the device."""
    flat = [x for t in tile_plan(sq, sk, window) for x in t]
    return torch.tensor(flat, dtype=torch.int32).pin_memory().to(
        device, non_blocking=True)


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


def _count(dtype: str) -> None:
    """Count one launch of the ``dtype`` kernel."""
    global LAUNCHES
    with _COUNT_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_DTYPE[dtype] += 1


def _u64(values) -> ctypes.Array:
    return (ctypes.c_uint64 * len(values))(*values)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """(B, Sq, H, D) causal attention of q (B, Sq, H, D) over k, v
    (B, Sk, KV, D), with an optional sliding ``window`` (0: none) and tanh
    logit ``softcap`` (0: none); float32 or bfloat16, output in q's dtype.

    k and v are made contiguous if they are not (a copy); the scaled q is a
    new tensor.  Nothing is transposed: the kernels read the JAX layout.
    """
    check_shapes(q, k, v, window=window, softcap=softcap)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"the CUDA flash attention takes CUDA tensors, got "
                         f"{q.device}, {k.device}, {v.device}")
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    bf16 = q.dtype == torch.bfloat16
    geo = tma_geometry(b, sq, sk, h, kv, d) if bf16 else None
    qs = scale_query(q).contiguous()
    k, v = k.contiguous(), v.contiguous()
    for t in (qs, k, v):
        if t.data_ptr() % 16:
            raise ValueError("q, k and v must start on a 16-byte boundary")
    out = torch.empty_like(qs)
    if b == 0 or sq == 0:
        return out
    with _LAUNCH_LOCK, torch.cuda.device(dev):
        lib = _lib()
        stream = torch.cuda.current_stream(dev).cuda_stream
        ptrs = (qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if bf16:
            plan = _plan_tensor(sq, sk, int(window), dev)
            err = lib.flash_attention_bf16_launch(
                *ptrs, plan.data_ptr(), geo.grid[1], b, sq, sk, h, kv, d,
                int(window), float(softcap), _u64(geo.q_dims),
                _u64(geo.q_strides), _u64(geo.kv_dims), _u64(geo.kv_strides),
                (ctypes.c_uint32 * 4)(*geo.box), geo.d_pad, geo.smem_bytes,
                stream)
        else:
            err = lib.flash_attention_f32_launch(
                *ptrs, b, sq, sk, h, kv, d, int(window), float(softcap),
                stream)
    if err:
        raise RuntimeError("flash_attention launch failed: "
                           + lib.flash_attention_error(err).decode())
    _count("bfloat16" if bf16 else "float32")
    return out
