"""RWKV-6 "Finch" time-mix block (arXiv:2404.05892), attention-free.

The port of ``repro.models.rwkv6``.  The recurrence per head (state S in
R^{d_k x d_v}):

    S_t   = diag(w_t) S_{t-1} + k_t^T v_t
    out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with data-dependent per-channel decay w_t = exp(-exp(ww_t)),
ww_t = w0 + LoRA(x_t), and token-shift mixing on every branch input.

:func:`time_mix` evaluates it in chunks of 128 tokens, as the JAX
``lax.scan`` does: within a chunk the interaction is a dense (L, L)
decay-masked product, across chunks a (B, H, hd, hd) f32 state flows
through :func:`repro_torch.utils.scan.scan` (a Python loop) of batched
einsums.  A sequence longer than a chunk
must be a multiple of it (the JAX package asserts the same); the port
raises a ``ValueError`` and does not pad.  :func:`time_mix_step` is the
O(1) single-token path of decode.  ``jnp.var`` is the population variance:
``correction=0``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from repro_torch.kernels._dtensor import is_dtensor
from repro_torch.models import layers
from repro_torch.sharding.act import shard_batch
from repro_torch.utils import scan as uscan

Params = Mapping[str, torch.Tensor]
CHUNK = 128


@dataclasses.dataclass(frozen=True)
class RWKVSpec:
    d_model: int
    n_heads: int                      # head_dim = d_model // n_heads
    d_ff: int
    lora_rank: int = 64
    dtype: Any = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def rwkv_init(gen: torch.Generator, s: RWKVSpec) -> dict:
    """Drawn in this order: wr, wk, wv, wg, wo, wa, wb, cm_k, cm_v, cm_r.
    w0, wa, wb, u and ln_out_scale are f32, as in the JAX init (wa rounded
    to the model's dtype first, as there)."""
    d, dt, dev = s.d_model, layers.torch_dtype(s.dtype), gen.device
    scale = 1.0 / math.sqrt(d)

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32)

    def lin(di, do):
        return (randn((di, do)) * scale).to(dt)

    f32 = dict(dtype=torch.float32, device=dev)
    p = {"mu": torch.full((5, d), 0.5, dtype=dt, device=dev)}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = lin(d, d)
    p["w0"] = torch.full((d,), -6.0, **f32)
    p["wa"] = lin(d, s.lora_rank).float()
    p["wb"] = randn((s.lora_rank, d)) * 0.01
    p["u"] = torch.zeros((d,), **f32)
    p["ln_out_scale"] = torch.ones((s.n_heads, s.head_dim), **f32)
    p["cm_mu"] = torch.full((2, d), 0.5, dtype=dt, device=dev)
    p["cm_k"] = lin(d, s.d_ff)
    p["cm_v"] = lin(s.d_ff, d)
    p["cm_r"] = lin(d, d)
    return p


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None
           ) -> torch.Tensor:
    """x_{t-1} along the sequence; ``prev`` seeds position 0 (decode)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([pad, x[:, :-1]], 1)


def _branches(p: Params, s: RWKVSpec, x: torch.Tensor, xs: torch.Tensor):
    dt = layers.torch_dtype(s.dtype)
    mu = p["mu"].float()
    xf, xsf = x.float(), xs.float()
    mix = [xf * mu[i] + xsf * (1 - mu[i]) for i in range(5)]
    r = (mix[0].to(dt) @ p["wr"]).float()
    k = (mix[1].to(dt) @ p["wk"]).float()
    v = (mix[2].to(dt) @ p["wv"]).float()
    ww = p["w0"] + torch.tanh(mix[3] @ p["wa"].float()) @ p["wb"]
    w = torch.exp(-torch.exp(ww))                                # in (0, 1)
    g = F.silu(mix[4].to(dt) @ p["wg"])
    # batch-only before the callers view D as heads (and the heads back
    # as D): a DTensor cannot view a TP-split D as heads that do not
    # divide the mesh axis; g likewise, for the product that gates the
    # output (see channel_mix)
    r, k, v, w, g = (shard_batch(t) for t in (r, k, v, w, g))
    return r, k, v, w, g


def _group_norm(out: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-head normalisation over the last axis, population variance."""
    mu = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    return (out - mu) * torch.rsqrt(var + 1e-5) * scale


def _wkv(r, k, v, w, u, *, h: int, chunk: int):
    """The chunked WKV recurrence of ``time_mix``: (out (B, S, H, hd),
    the state at the sequence's end)."""
    b, seq, d = r.shape
    hd = d // h
    n_chunks = seq // chunk
    shape = (b, n_chunks, chunk, h, hd)
    rc, kc, vc, wc = (t.reshape(shape).permute(1, 0, 3, 2, 4)
                      for t in (r, k, v, w))                     # (N,B,H,L,hd)

    logw = torch.log(torch.clamp_min(wc, 1e-38))
    cum = torch.cumsum(logw, 3)                                  # prod w, s<=t
    # Clamp the within-chunk log-decay so exp(-cum) cannot overflow f32
    # (the JAX package's clamp; it bites only when a channel forgets more
    # than e^30 within one chunk).
    cum = torch.clamp_min(cum, -30.0)
    ct = cum - logw                                              # cum_{t-1}
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)

    def scan_chunk(state, inp):
        rc_, kc_, vc_, cum_, ct_ = inp
        # inter-chunk: r_t . (decay(chunk start -> t-1) * S_prev)
        decay_in = torch.exp(ct_)                                # (B,H,L,hd)
        out = torch.einsum("bhld,bhdv->bhlv", rc_ * decay_in, state)
        # intra-chunk, strictly lower-triangular (s < t)
        a = torch.einsum("bhld,bhsd->bhls", rc_ * torch.exp(ct_),
                         kc_ * torch.exp(-cum_))
        a = torch.where(tri, a, 0.0)
        out = out + torch.einsum("bhls,bhsv->bhlv", a, vc_)
        # the current token's bonus u
        out = out + (rc_ * (u[None, :, None, :] * kc_)).sum(
            -1, keepdim=True) * vc_
        # the state at the chunk's end
        total = cum_[:, :, -1:, :]                               # (B,H,1,hd)
        state = state * torch.exp(total.squeeze(2))[..., None] + torch.einsum(
            "bhsd,bhsv->bhdv", kc_ * torch.exp(total - cum_), vc_)
        return state, out

    s0 = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    state, outs = uscan.scan(scan_chunk, s0, (rc, kc, vc, cum, ct))
    return outs.permute(1, 0, 3, 2, 4).reshape(b, seq, h, hd), state


def _on_rows(r, k, v, w, u, *, h: int, chunk: int):
    """:func:`_wkv` of DTensor rows (sharded on the batch only) on each
    rank's own rows, as GSPMD keeps a per-row recurrence local (DTensor
    cannot carry the chunk loop's views and products through every
    layout): ``u``'s gradient a partial sum over the ranks that split the
    rows; out and state laid out as the rows."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh, rows = r.device_mesh, r.placements
    local = [t.redistribute(mesh, rows).to_local() for t in (r, k, v, w)]
    u_l = u.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate()
                         for p in rows])
    out, state = _wkv(*local, u_l, h=h, chunk=chunk)
    b, seq, d = r.shape

    def laid(t, shape):
        return DTensor.from_local(t, mesh, rows, run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape, device="meta")
                                  .stride())

    return (laid(out, (b, seq, h, d // h)),
            laid(state, (b, h, d // h, d // h)))


def time_mix(p: Params, s: RWKVSpec, x: torch.Tensor, *,
             chunk: int = CHUNK, return_state: bool = False):
    """Full-sequence chunked evaluation (training, prefill).

    With ``return_state`` also returns (final state, last input) to seed
    the O(1) decode path.
    """
    b, seq, d = x.shape
    h, hd = s.n_heads, s.head_dim
    chunk = min(chunk, seq)
    n_chunks = seq // chunk
    if n_chunks * chunk != seq:
        raise ValueError(f"rwkv time_mix: a sequence of {seq} tokens, longer "
                         f"than the {chunk}-token chunk, must be a multiple "
                         f"of it")
    r, k, v, w, g = _branches(p, s, x, _shift(x))
    u = p["u"].reshape(h, hd)
    wkv = _on_rows if is_dtensor(r) else _wkv
    out, state = wkv(r, k, v, w, u, h=h, chunk=chunk)

    # per-head groupnorm, then the output gate and projection
    out = shard_batch(_group_norm(out, p["ln_out_scale"]))
    out = out.reshape(b, seq, d).to(layers.torch_dtype(s.dtype)) * g
    out = shard_batch(out @ p["wo"])
    if return_state:
        return out, state, x[:, -1]
    return out


def time_mix_step(p: Params, s: RWKVSpec, x: torch.Tensor,
                  state: torch.Tensor, x_prev: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) decode step.  x: (B, D); state: (B, H, hd, hd); x_prev: (B, D)."""
    b, d = x.shape
    h, hd = s.n_heads, s.head_dim
    r, k, v, w, g = _branches(p, s, x[:, None], x_prev[:, None])
    r, k, v, w = (t[:, 0].reshape(b, h, hd) for t in (r, k, v, w))
    # batch-only, as r, k, v: the einsums below flatten (B, H)
    state = shard_batch(state)
    u = p["u"].reshape(h, hd)
    kv = torch.einsum("bhd,bhv->bhdv", k, v)
    out = torch.einsum("bhd,bhdv->bhv", r, state + u[None, :, :, None] * kv)
    state = state * w[..., None] + kv
    out = shard_batch(_group_norm(out, p["ln_out_scale"]))
    out = out.reshape(b, d).to(layers.torch_dtype(s.dtype)) * g[:, 0]
    return shard_batch(out @ p["wo"]), state, x


def channel_mix(p: Params, s: RWKVSpec, x: torch.Tensor,
                x_prev: torch.Tensor | None = None) -> torch.Tensor:
    dt = layers.torch_dtype(s.dtype)
    mu = p["cm_mu"].float()
    xf = x.float()
    xs = _shift(x, x_prev).float()
    xk = (xf * mu[0] + xs * (1 - mu[0])).to(dt)
    xr = (xf * mu[1] + xs * (1 - mu[1])).to(dt)
    k = torch.square(torch.relu(xk @ p["cm_k"]))
    # both factors batch-only: DTensor (as torch 2.11 lays it out) cannot
    # multiply a partial sum by a batch-split factor
    return (shard_batch(torch.sigmoid(xr @ p["cm_r"]))
            * shard_batch(k @ p["cm_v"]))
