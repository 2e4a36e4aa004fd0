"""Block-kind-aware serving cache + the single-token decode step.

The port of ``repro.models.kvcache``.  Cache layout per layer kind
(B = batch, S = max sequence):

  global :  k, v   (B, S, KV, head_dim)
  local  :  k, v   (B, min(window, S), KV, head_dim)  ring buffer, RoPE'd
                   at write, slot ``pos % window``
  rwkv   :  state (B, H, hd, hd) f32 + token-shift carries tm_prev,
            cm_prev (B, D)
  rglru  :  h (B, W) f32 + conv window (B, conv_width - 1, W)

:func:`decode_step` writes the attention caches **in place** and puts each
recurrent layer's new state into its slot's dict, returning the same list:
the JAX step returns a new cache, which its ``jit`` (no donation) copies
whole every tick (8.5 GB at gemma2_9b's full width, 4 slots, 8,192
positions).  A row whose position is outside an attention cache is
dropped, as the JAX scatters' ``mode="drop"`` does.

On a partitioned step (DTensor parameters) the cache is laid out by the
partitioning rules' cache specs (:func:`init_cache_laid_out`; sequence
parallel on the global layers' KV) and each write is local: every rank
writes the positions that fall in its shard of the sequence, for its rows
(:func:`_write_local`, :func:`_put_local`), which is what GSPMD makes of
the JAX package's scatters into a sharded cache; DTensor has no in-place
scatter into a sharded dim.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.models import layers, rglru, rwkv6, transformer
from repro_torch.sharding.act import shard_batch

Cache = list[dict[str, torch.Tensor]]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Cache:
    """Zero caches for every layer on ``device`` (None: the card)."""
    dev = resolve_device(device)
    dt = layers.torch_dtype(cfg.dtype)
    f32 = dict(dtype=torch.float32, device=dev)
    cache: Cache = []
    for i in range(cfg.n_layers):
        kind = cfg.block_kind(i)
        if kind in transformer.ATTN_KINDS:
            s = max_seq if kind == "global" else min(cfg.window, max_seq)
            shape = (batch, s, cfg.n_kv_heads, cfg.head_dim)
            cache.append({"k": torch.zeros(shape, dtype=dt, device=dev),
                          "v": torch.zeros(shape, dtype=dt, device=dev)})
        elif kind == "rwkv":
            hd = cfg.d_model // cfg.n_heads
            carry = (batch, cfg.d_model)
            cache.append({
                "state": torch.zeros((batch, cfg.n_heads, hd, hd), **f32),
                "tm_prev": torch.zeros(carry, dtype=dt, device=dev),
                "cm_prev": torch.zeros(carry, dtype=dt, device=dev)})
        elif kind == "rglru":
            w = cfg.lru_width or cfg.d_model
            cache.append({
                "h": torch.zeros((batch, w), **f32),
                "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dt,
                                    device=dev)})
        else:
            raise ValueError(f"unknown block kind {kind!r}")
    return cache


def init_cache_laid_out(cfg: ModelConfig, batch: int, max_seq: int,
                        params: transformer.Transformer) -> Cache:
    """:func:`init_cache` on the parameters' device; when they are
    DTensors, laid out over their mesh by ``partitioning.cache_shardings``
    (each rank's zero shard made where it lies, no global cache)."""
    if not _is_dtensor(params.embed):
        return init_cache(cfg, batch, max_seq, params.device)
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import partitioning as part
    mesh = params.embed.device_mesh
    meta = init_cache(cfg, batch, max_seq, torch.device("meta"))
    laid = part.distribute(meta, part.cache_shardings(cfg, mesh, meta), mesh)
    dev = params.embed.to_local().device
    return [{k: DTensor.from_local(
        torch.zeros_like(t.to_local(), device=dev), mesh, t.placements,
        run_check=False, shape=t.shape, stride=t.stride())
        for k, t in slot.items()} for slot in laid]


def _is_dtensor(t) -> bool:
    from repro_torch.kernels._dtensor import is_dtensor
    return is_dtensor(t)


def _batch_layout(buf, x):
    """``x`` (a DTensor or a plain tensor taken as replicated) laid out as
    ``buf``'s rows: its dim 0 sharded where ``buf``'s is, replicated
    elsewhere; returns the local tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = buf.device_mesh
    rows = [Shard(0) if p == Shard(0) else Replicate()
            for p in buf.placements]
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, rows).to_local()


def _seq_offset(buf) -> int:
    """The global position of this rank's first cache slot."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    return compute_local_shape_and_global_offset(
        buf.shape, buf.device_mesh, buf.placements)[1][1]


def _put_local(buf, start: int, n: int, val) -> None:
    """``buf[:, (start + j) % S] = val[:, j]`` for j < n, of a DTensor
    cache of S slots: this rank's rows, at the slots in its sequence
    shard, as slice copies (one run of consecutive slots, two where the
    ring wraps)."""
    lb, off = buf.to_local(), _seq_offset(buf)
    slots = buf.shape[1]
    v = _batch_layout(buf, val.to(buf.dtype))
    j = 0
    while j < n:
        p = (start + j) % slots
        run = min(n - j, slots - p)             # up to the ring's end
        lo, hi = max(p, off), min(p + run, off + lb.shape[1])
        if lo < hi:
            lb[:, lo - off:hi - off] = v[:, j + lo - p:j + hi - p]
        j += run


def prefill_to_cache(cfg: ModelConfig, entries: list[dict], cache: Cache,
                     seq_len: int) -> Cache:
    """Write ``forward(capture_cache=True)`` entries into ``cache`` (the
    attention caches in place, the recurrent states into their slots'
    dicts); returns it."""
    for i, (entry, slot) in enumerate(zip(entries, cache)):
        kind = cfg.block_kind(i)
        if kind in transformer.ATTN_KINDS and _is_dtensor(slot["k"]):
            n = entry["k"].shape[1]
            start = 0 if kind == "global" else seq_len - n
            for f in ("k", "v"):
                _put_local(slot[f], start, n, entry[f])
        elif kind == "global":
            n = entry["k"].shape[1]
            slot["k"][:, :n] = entry["k"]
            slot["v"][:, :n] = entry["v"]
        elif kind == "local":
            # the entry holds the last `window` tokens; place them so the
            # ring index (pos % window) lines up with absolute positions
            w = slot["k"].shape[1]
            n = entry["k"].shape[1]
            idx = torch.arange(seq_len - n, seq_len,
                               device=slot["k"].device) % w
            slot["k"][:, idx] = entry["k"].to(slot["k"].dtype)
            slot["v"][:, idx] = entry["v"].to(slot["v"].dtype)
        else:
            # the JAX package's whole-entry replace: a prompt shorter than
            # the conv window leaves a shorter conv entry, as there
            slot.update({k: v.to(slot[k].dtype) for k, v in entry.items()})
    return cache


def _write(buf: torch.Tensor, rows: torch.Tensor, idx: torch.Tensor,
           val: torch.Tensor) -> None:
    """``buf[rows, idx] = val`` for the rows whose idx lies in the buffer;
    the others are dropped (they write back what their clamped index holds,
    which needs no boolean indexing and so no wait for the device).  A
    DTensor cache is written by :func:`_write_local`."""
    if _is_dtensor(buf):
        return _write_local(buf, idx, val)
    ok = (idx >= 0) & (idx < buf.shape[1])
    at = idx.clamp(0, buf.shape[1] - 1)
    keep = buf[rows, at]
    buf[rows, at] = torch.where(ok[:, None, None], val.to(buf.dtype), keep)


def _write_local(buf, idx: torch.Tensor, val: torch.Tensor) -> None:
    """:func:`_write` of a DTensor cache: each rank writes its rows whose
    position falls in its sequence shard (the others drop, as a position
    outside the cache does)."""
    lb = buf.to_local()
    _write(lb, torch.arange(lb.shape[0], device=lb.device),
           _batch_layout(buf, idx) - _seq_offset(buf),
           _batch_layout(buf, val))


def _decode_attn_layer(layer: transformer.DecoderLayer, x: torch.Tensor,
                       slot: dict, pos: torch.Tensor) -> torch.Tensor:
    """pos: (B,) per-row position (continuous batching)."""
    spec = layer.spec
    b = x.shape[0]
    rows = torch.arange(b, device=x.device)
    q, k, v = layers.qkv(layer.attn, spec, x, pos[:, None])      # (B,1,·,·)
    if layer.kind == "global":
        _write(slot["k"], rows, pos, k[:, 0])
        _write(slot["v"], rows, pos, v[:, 0])
        o = layers.decode_attention(q, slot["k"], slot["v"], pos, spec=spec)
    else:                                                        # local ring
        w = slot["k"].shape[1]
        ring = pos % w
        _write(slot["k"], rows, ring, k[:, 0])
        _write(slot["v"], rows, ring, v[:, 0])
        # valid slots: the last min(pos+1, w) writes; RoPE is baked in at
        # write time, so the order within the ring does not matter
        valid = (torch.arange(w, device=x.device)[None, :]
                 <= torch.clamp(pos, max=w - 1)[:, None])
        o = _ring_attention(q, slot["k"], slot["v"], valid, spec)
    return o.reshape(b, 1, -1) @ layer.attn["wo"]


def _ring_attention(q, k_ring, v_ring, valid, spec):
    """valid: (B, window) mask of live ring slots."""
    b, _, h, d = q.shape
    kv = k_ring.shape[2]
    g = h // kv
    # the JAX divisor is an f32 array: the division runs in f32
    qg = q.reshape(b, kv, g, d).float() / math.sqrt(d)
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_ring.float())
    if spec.softcap > 0:
        logits = torch.tanh(logits / spec.softcap) * spec.softcap
    logits = torch.where(valid[:, None, None, :], logits, ref.MASKED)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_ring.float())
    o = o / p.sum(-1)[..., None]
    return o.reshape(b, 1, h, d).to(q.dtype)


@torch.no_grad()
def decode_step(params: transformer.Transformer, cfg: ModelConfig,
                cache: Cache, token: torch.Tensor, pos):
    """One serving step: token (B, 1) + cache at ``pos`` -> (logits (B, V),
    cache).  ``pos`` is a scalar or (B,): each row advances at its own
    position.  The cache is updated in place and returned."""
    dev = params.device
    token = torch.as_tensor(token, device=dev)
    b = token.shape[0]
    pos = torch.broadcast_to(torch.as_tensor(pos, device=dev).long(), (b,))
    # pinned batch-only, the lookup and each block's output: DTensor (as
    # torch 2.11 lays it out) cannot add a D-split residual to a partial
    x = shard_batch(transformer._vocab_split(params.embed)[token.long()])
    if cfg.pos == "sinusoidal":
        x = x + layers.sinusoidal(pos, cfg.d_model)[:, None].to(x.dtype)
    for layer, slot in zip(params.layers, cache):
        h = layers.norm_apply(layer.norm1, x, cfg.norm)
        if layer.kind in transformer.ATTN_KINDS:
            x = x + shard_batch(_decode_attn_layer(layer, h, slot, pos))
        elif layer.kind == "rwkv":
            o, state, tm_prev = rwkv6.time_mix_step(
                layer.tm, layer.spec, h[:, 0], slot["state"],
                slot["tm_prev"].to(h.dtype))
            x = x + shard_batch(o[:, None])
            y = layers.norm_apply(layer.norm2, x, cfg.norm)
            x = x + shard_batch(rwkv6.channel_mix(
                layer.tm, layer.spec, y, x_prev=slot["cm_prev"].to(y.dtype)))
            slot.update(state=state,
                        tm_prev=tm_prev.to(slot["tm_prev"].dtype),
                        cm_prev=y[:, 0].to(slot["cm_prev"].dtype))
            continue
        else:
            o, h_new, conv = rglru.rglru_step(layer.rec, layer.spec, h[:, 0],
                                              slot["h"], slot["conv"])
            x = x + shard_batch(o[:, None])
            slot.update(h=h_new, conv=conv)
        y = layers.norm_apply(layer.norm2, x, cfg.norm)
        x = x + shard_batch(layer.ffn(y)[0])
    x = layers.norm_apply(params.final_norm, x, cfg.norm)
    return params.unembed(x)[:, 0], cache
