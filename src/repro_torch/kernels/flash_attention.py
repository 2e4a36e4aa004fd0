"""Wrappers of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and the backward
(``csrc/flash_attention_bwd.cu``).

:func:`flash_attention` replaces the JAX package's Pallas
``flash_attention``: the same layout ``(B, Sq, H, D)`` for q and the output
and ``(B, Sk, KV, D)`` for k and v, and the same signature.  q is scaled by
``1/sqrt(D)`` in its own dtype before the launch, as the JAX function does
before its ``pallas_call``.  Each dtype has one kernel and no fallback to
the other: bfloat16 goes to the tensor-core kernel (wgmma + TMA), float32
to the scalar one.  CUDA or meta tensors only; the plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.

Training differentiates attention as the JAX custom VJP ``_flash`` does,
on q already scaled: :func:`flash_attention_fwd` also returns each row's
log-sum-exp, and :func:`flash_attention_bwd` (the counterpart of
``repro.models.layers._flash_vjp_bwd``) returns dq, dk and dv from it;
bfloat16 goes to the tensor-core backward (wgmma + TMA), float32 to the
scalar one.  Their plain versions are ``ref.flash_attention_fwd_ref`` and
``ref.flash_attention_bwd_ref``.

Each launch is a custom op (``torch.ops.repro_torch.flash_fwd``,
``flash_fwd_lse``, ``flash_bwd``): on a CUDA tensor it launches the kernel;
on a meta tensor it makes empty outputs of the right shapes and dtypes and
launches nothing, and under ``torch.utils.flop_counter.FlopCounterMode`` it
counts its own work, 4 * D flops a live (q, k) pair and head forward and
10 * D backward (``launch.roofline``), on either device.

The tensor-core kernels' geometry is computed here, in Python the CPU tests
reach: :func:`tile_plan` (the live KV tiles of each query tile, heaviest
first), :func:`bwd_tile_plans` (the backward's two plans) and
:func:`tma_geometry` (the tensor maps' dims, byte strides and box, the grid
and the shared memory), all passed to the launches.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch
from torch import Tensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build, _dtensor
from repro_torch.launch import roofline

# Launches of the forward kernels in this process (the main path's proof of
# use): all of them, and by dtype (bfloat16: tensor-core kernel, float32:
# scalar); those of the backward (one a flash_attention_bwd call), by dtype
# likewise.
LAUNCHES = 0
LAUNCHES_BY_DTYPE = {"bfloat16": 0, "float32": 0}
LAUNCHES_BWD = 0
LAUNCHES_BWD_BY_DTYPE = {"bfloat16": 0, "float32": 0}

DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256

# The tensor-core forward's tiles: 128 query rows a block (two warpgroups
# of 64), 64 keys a KV tile, every tile cut into 64 x 64 bf16 boxes (8 KB).
# The tensor-core backward's tiles: 64 keys and 64 query rows; its dK/dV
# kernel keeps a 16 KB f32 exchange besides its tiles.
BQ = 128
BK = 64
BWD_TILE = 64
BOX = (64, 1, 64, 1)
PANEL_BYTES = 64 * 64 * 2
STAGES = 2
BWD_EXCHANGE_BYTES = 32 * 128 * 4
MAX_SMEM_BYTES = 232_448           # what an H100 block can use
# TMA's limits (cuTensorMapEncodeTiled): dims up to 2^32, byte strides
# multiples of 16 below 2^40; grid.y of the launch up to 65,535 tiles.
_TMA_MAX_DIM = 1 << 32
_TMA_MAX_STRIDE = 1 << 40
_MAX_GRID_Y = 65_535

# Each kernel's shared-memory opt-in is set before every launch.
_FWD = _build.Library(
    "flash_attention", "flash_attention_error", counts=__name__,
    by="LAUNCHES_BY_DTYPE", opt_in=True,
    entries={"flash_attention_f32_launch": "5p 7i f",
             "flash_attention_bf16_launch": "6p 8i f 4Q I 2i"})
_BWD = _build.Library(
    "flash_attention_bwd", "flash_attention_bwd_error", counts=__name__,
    total="LAUNCHES_BWD", by="LAUNCHES_BWD_BY_DTYPE", opt_in=True,
    entries={"flash_attention_bwd_launch": "i 10p 7i f",
             "flash_attention_bwd_bf16_launch": "11p i p 8i f 4Q I 3i"})


def tile_plan(sq: int, sk: int, window: int, bq: int = BQ
              ) -> list[tuple[int, int, int]]:
    """``(q0, lo, hi)`` for every ``bq``-row query tile: the live 64-key
    tiles ``[lo, hi)`` of ``repro.models.layers._causal_kv_range`` (q_offset
    0; the last row capped at ``sq - 1``), heaviest tiles first (later
    tiles first among equals)."""
    nk = -(-sk // BK)
    plan = []
    for q0 in range(0, sq, bq):
        hi = min((min(q0 + bq, sq) - 1) // BK + 1, nk)
        lo = max((q0 - window + 1) // BK, 0) if window > 0 else 0
        plan.append((q0, lo, hi))
    return sorted(plan, key=lambda t: (t[1] - t[2], -t[0]))


def bwd_tile_plans(sq: int, sk: int, window: int
                   ) -> tuple[list[tuple[int, int, int]],
                              list[tuple[int, int, int]]]:
    """The tensor-core backward's plans, heaviest tiles first: for its
    dK/dV kernel ``(k0, qlo, qhi)`` of every 64-key tile, the live 64-row
    query tiles ``[qlo, qhi)`` of ``repro.models.layers._q_range`` (q_offset
    0; empty for keys past the last row); for its dQ kernel ``(q0, lo, hi)``
    of every 64-row query tile, as :func:`tile_plan`."""
    t = BWD_TILE
    nq = -(-sq // t)
    kv_plan = []
    for k0 in range(0, sk, t):
        hi = min((k0 + t + window - 2) // t + 1, nq) if window > 0 else nq
        kv_plan.append((k0, min(k0 // t, hi), hi))
    kv_plan.sort(key=lambda p: (p[1] - p[2], p[0]))
    return kv_plan, tile_plan(sq, sk, window, bq=t)


def bwd_smem_bytes(d_pad: int) -> tuple[int, int]:
    """Dynamic shared memory of the tensor-core backward's (dK/dV, dQ)
    kernels at padded head dim ``d_pad``: 1 KB of alignment slack, two
    resident and 2 x STAGES streamed tiles of ``d_pad / 64`` boxes, the dK/dV
    exchange, 64 bytes of mbarriers."""
    tiles = (2 + 2 * STAGES) * (d_pad // 64) * PANEL_BYTES
    dkdv = 1024 + tiles + BWD_EXCHANGE_BYTES + 64
    dq = 1024 + tiles + 64
    assert max(dkdv, dq) <= MAX_SMEM_BYTES, (dkdv, dq)
    return dkdv, dq


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


@functools.lru_cache(maxsize=256)
def _bwd_plan_tensor(sq: int, sk: int, window: int, device: torch.device
                     ) -> tuple[torch.Tensor, int, int]:
    """Both backward plans in one int32 tensor on the card (dK/dV's, then
    dQ's) and their tile counts, made once per shape as
    :func:`_plan_tensor`."""
    kv_plan, q_plan = bwd_tile_plans(sq, sk, window)
    flat = [x for t in kv_plan + q_plan for x in t]
    tensor = torch.tensor(flat, dtype=torch.int32).pin_memory().to(
        device, non_blocking=True)
    return tensor, len(kv_plan), len(q_plan)


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


def reset_launches() -> None:
    """Set every count of this module to 0."""
    _build.reset_counts(_FWD)
    _build.reset_counts(_BWD)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """(B, Sq, H, D) causal attention of q (B, Sq, H, D) over k, v
    (B, Sk, KV, D), with an optional sliding ``window`` (0: none) and tanh
    logit ``softcap`` (0: none); float32 or bfloat16, output in q's dtype.

    k and v are made contiguous if they are not (a copy); the scaled q is a
    new tensor.  Nothing is transposed: the kernels read the JAX layout.
    """
    check_shapes(q, k, v, window=window, softcap=softcap)
    return flash_attention_fwd(scale_query(q), k, v, window=window,
                               softcap=softcap)


def _check_device(*tensors: torch.Tensor) -> None:
    """CUDA tensors (a launch) or meta tensors (shapes only), all on one
    device; or DTensors, whose shards may lie on the CPU (the op's CPU
    kernel, ``kernels._dtensor``)."""
    dev = tensors[0].device
    dtensors = all(map(_dtensor.is_dtensor, tensors))
    if (dev.type not in ("cuda", "meta") and not dtensors) or any(
            t.device != dev for t in tensors):
        raise ValueError(f"the CUDA flash attention takes CUDA tensors, got "
                         f"{', '.join(str(t.device) for t in tensors)}")


def _check_aligned(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("the flash attention's tensors must start on a "
                             "16-byte boundary")


def flash_attention_fwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, softcap: float = 0.0,
                        with_lse: bool = False):
    """The forward kernel on q already scaled by ``1/sqrt(D)``: the output
    (B, Sq, H, D), and with ``with_lse`` also each row's log-sum-exp
    ``m + log(max(l, 1e-30))`` of the softcapped, masked logits, natural-log
    units, f32 (B, H, Sq) (what :func:`flash_attention_bwd` takes)."""
    check_shapes(qs, k, v, window=window, softcap=softcap)
    _check_device(qs, k, v)
    if qs.dtype == torch.bfloat16:
        tma_geometry(qs.shape[0], qs.shape[1], k.shape[1], qs.shape[2],
                     k.shape[2], qs.shape[3])
    op = _fwd_lse_op if with_lse else _fwd_op
    return op(qs, k, v, int(window), float(softcap))


def _launch_fwd(qs: Tensor, k: Tensor, v: Tensor, window: int,
                softcap: float, with_lse: bool):
    b, sq, h, d = qs.shape
    sk, kv = k.shape[1], k.shape[2]
    bf16 = qs.dtype == torch.bfloat16
    geo = tma_geometry(b, sq, sk, h, kv, d) if bf16 else None
    qs, k, v = qs.contiguous(), k.contiguous(), v.contiguous()
    _check_aligned(qs, k, v)
    dev = qs.device
    out = torch.empty_like(qs)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=dev)
           if with_lse else None)
    if b == 0 or sq == 0:
        return out, lse
    ptrs = (qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None)
    if bf16:
        plan = _plan_tensor(sq, sk, int(window), dev)
        _build.launch(
            _FWD, "flash_attention_bf16_launch", dev, *ptrs, plan.data_ptr(),
            geo.grid[1], b, sq, sk, h, kv, d, int(window), float(softcap),
            _build.u64(geo.q_dims), _build.u64(geo.q_strides),
            _build.u64(geo.kv_dims), _build.u64(geo.kv_strides),
            _build.u32(geo.box), geo.d_pad, geo.smem_bytes, label="bfloat16")
    else:
        _build.launch(
            _FWD, "flash_attention_f32_launch", dev, *ptrs, b, sq, sk, h, kv,
            d, int(window), float(softcap), label="float32")
    return out, lse


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         device_types="cuda")
def _fwd_op(qs: Tensor, k: Tensor, v: Tensor, window: int,
            softcap: float) -> Tensor:
    return _launch_fwd(qs, k, v, window, softcap, False)[0]


@torch.library.custom_op("repro_torch::flash_fwd_lse", mutates_args=(),
                         device_types="cuda")
def _fwd_lse_op(qs: Tensor, k: Tensor, v: Tensor, window: int,
                softcap: float) -> tuple[Tensor, Tensor]:
    return _launch_fwd(qs, k, v, window, softcap, True)


@_fwd_op.register_fake
def _(qs, k, v, window, softcap):
    return qs.new_empty(qs.shape)


@_fwd_lse_op.register_fake
def _(qs, k, v, window, softcap):
    b, sq, h, _ = qs.shape
    return qs.new_empty(qs.shape), qs.new_empty((b, h, sq),
                                                dtype=torch.float32)


@register_flop_formula([torch.ops.repro_torch.flash_fwd,
                        torch.ops.repro_torch.flash_fwd_lse])
def _fwd_flops(qs_shape, k_shape, v_shape, window, softcap, *args, **kw):
    b, sq, h, d = qs_shape
    return roofline.flash_fwd_flops(b, sq, h, d, window)


def check_bwd_shapes(qs, k, v, o, do, lse, *, window: int,
                     softcap: float) -> None:
    """What the backward takes (the forward's shapes, o and dO like q, lse
    f32 (B, H, Sq)); raises on anything else."""
    check_shapes(qs, k, v, window=window, softcap=softcap)
    b, sq, h, _ = qs.shape
    for name, t in (("o", o), ("dO", do)):
        if t.shape != qs.shape or t.dtype != qs.dtype:
            raise ValueError(f"{name} must be {tuple(qs.shape)} "
                             f"{qs.dtype}, got {tuple(t.shape)} {t.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b}, {h}, {sq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def flash_attention_bwd(qs: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, window: int = 0, softcap: float = 0.0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_fwd` at ``qs`` (q scaled by
    ``1/sqrt(D)``; dq is with respect to it), given its output ``o``, the
    output's gradient ``do`` and the forward's ``lse``.  f32 sums inside
    (bfloat16: on the tensor cores, P and dS rounded to bfloat16 as their
    operands), results in the inputs' dtype; no atomics, so the same inputs
    give the same bits."""
    check_bwd_shapes(qs, k, v, o, do, lse, window=window, softcap=softcap)
    _check_device(qs, k, v, o, do, lse)
    b, sq, h, d = qs.shape
    sk, kv = k.shape[1], k.shape[2]
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B * H = {b * h} blocks exceed the grid's "
                         f"{_MAX_GRID_Y}")
    if qs.dtype == torch.bfloat16:
        tma_geometry(b, sq, sk, h, kv, d)
        if -(-sk // BWD_TILE) > _MAX_GRID_Y:
            raise ValueError(f"Sk = {sk} needs more key tiles than the "
                             f"grid's {_MAX_GRID_Y}")
    return _bwd_op(qs, k, v, o, do, lse, int(window), float(softcap))


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=(),
                         device_types="cuda")
def _bwd_op(qs: Tensor, k: Tensor, v: Tensor, o: Tensor, do: Tensor,
            lse: Tensor, window: int, softcap: float
            ) -> tuple[Tensor, Tensor, Tensor]:
    b, sq, h, d = qs.shape
    sk, kv = k.shape[1], k.shape[2]
    bf16 = qs.dtype == torch.bfloat16
    geo = tma_geometry(b, sq, sk, h, kv, d) if bf16 else None
    qs, k, v, o, do, lse = (t.contiguous() for t in (qs, k, v, o, do, lse))
    _check_aligned(qs, k, v, o, do, lse)
    dev = qs.device
    dq, dk, dv = (torch.empty_like(t) for t in (qs, k, v))
    if b == 0 or sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in (qs, k, v, o, do, lse, delta, dq, dk, dv)]
    if bf16:
        plans, n_kv, n_q = _bwd_plan_tensor(sq, sk, int(window), dev)
        _build.launch(
            _BWD, "flash_attention_bwd_bf16_launch", dev, *ptrs,
            plans.data_ptr(), n_kv, plans.data_ptr() + 3 * 4 * n_kv, n_q, b,
            sq, sk, h, kv, d, int(window), float(softcap),
            _build.u64(geo.q_dims), _build.u64(geo.q_strides),
            _build.u64(geo.kv_dims), _build.u64(geo.kv_strides),
            _build.u32(geo.box), geo.d_pad, *bwd_smem_bytes(geo.d_pad),
            label="bfloat16")
    else:
        _build.launch(
            _BWD, "flash_attention_bwd_launch", dev, 0, *ptrs, b, sq, sk, h,
            kv, d, int(window), float(softcap), label="float32")
    return dq, dk, dv


@_bwd_op.register_fake
def _(qs, k, v, o, do, lse, window, softcap):
    return qs.new_empty(qs.shape), k.new_empty(k.shape), v.new_empty(v.shape)


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _bwd_flops(qs_shape, k_shape, v_shape, o_shape, do_shape, lse_shape,
               window, softcap, *args, **kw):
    b, sq, h, d = qs_shape
    return roofline.flash_bwd_flops(b, sq, h, d, window)


# --------------------------------------------------------------------------
# under DTensor: the ops' layouts on one mesh dim, and their CPU kernels
# --------------------------------------------------------------------------


def _head_split(qs, k) -> bool:
    """q's and kv's heads shard together only where both divide, so that
    each shard keeps whole GQA groups."""
    return _dtensor.divides(qs.mesh, qs.shape[2], k.shape[2])


@_dtensor.register_sharding(torch.ops.repro_torch.flash_fwd.default)
def _fwd_sharding(qs, k, v, window, softcap):
    """Replicated, batch sharded, or heads sharded: the sequence and D
    stay whole (each query row needs every key of its window)."""
    rep, shard, _ = _dtensor.placements()
    out = [([rep], [rep] * 3 + [None, None]),
           ([shard(0)], [shard(0)] * 3 + [None, None])]
    if _head_split(qs, k):
        out.append(([shard(2)], [shard(2)] * 3 + [None, None]))
    return out


@_dtensor.register_sharding(torch.ops.repro_torch.flash_fwd_lse.default)
def _fwd_lse_sharding(qs, k, v, window, softcap):
    """As :func:`_fwd_sharding`; the (B, H, Sq) LSE follows the output's
    batch or heads."""
    rep, shard, _ = _dtensor.placements()
    out = [([rep, rep], [rep] * 3 + [None, None]),
           ([shard(0), shard(0)], [shard(0)] * 3 + [None, None])]
    if _head_split(qs, k):
        out.append(([shard(2), shard(1)], [shard(2)] * 3 + [None, None]))
    return out


@_dtensor.register_sharding(torch.ops.repro_torch.flash_bwd.default)
def _bwd_sharding(qs, k, v, o, do, lse, window, softcap):
    """The forward's layouts, the gradients as their inputs."""
    rep, shard, _ = _dtensor.placements()
    out = [([rep] * 3, [rep] * 6 + [None, None]),
           ([shard(0)] * 3, [shard(0)] * 6 + [None, None])]
    if _head_split(qs, k):
        out.append(([shard(2)] * 3,
                    [shard(2)] * 5 + [shard(1), None, None]))
    return out


@_dtensor.register_cpu(_fwd_op)
def _(qs, k, v, window, softcap):
    from repro_torch.kernels import ref
    return ref.flash_attention_fwd_ref(qs, k, v, window=window,
                                       softcap=softcap)[0]


@_dtensor.register_cpu(_fwd_lse_op)
def _(qs, k, v, window, softcap):
    from repro_torch.kernels import ref
    return ref.flash_attention_fwd_ref(qs, k, v, window=window,
                                       softcap=softcap)


@_dtensor.register_cpu(_bwd_op)
def _(qs, k, v, o, do, lse, window, softcap):
    from repro_torch.kernels import ref
    return ref.flash_attention_bwd_ref(qs, k, v, o, do, lse, window=window,
                                       softcap=softcap)
