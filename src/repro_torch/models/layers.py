"""Core decoder layers: norms, RoPE, GQA attention, gated MLP.

The port of ``repro.models.layers``.  Every layer is an ``init`` that makes
a dict of tensors from an explicit ``torch.Generator`` plus an ``apply``
over such a dict (or an ``nn.ParameterDict`` of the same keys).  Weights
keep the JAX ``(d_in, d_out)`` orientation, so ``x @ w`` is the JAX
product and weights cross between the packages as copies.

Each function follows the JAX dtype flow line by line: norm statistics in
f32 applied in x's dtype, RoPE's cos/sin cast to x's dtype before the
multiply, the MLP activation in f32, and q scaled by ``1/sqrt(D)`` in its
own dtype before attention.  A Python float that JAX would take as weakly
typed is rounded to the tensor's dtype first (:func:`_weak`).

Full-sequence attention (:func:`blockwise_attention`) is the hand-written
CUDA flash kernel on a CUDA tensor and its plain version on a CPU tensor
(``repro_torch.kernels.ops``); ``impl`` pins one of the two.  Where autograd
records it (training), it is :class:`_Flash`, the counterpart of the JAX
custom VJP ``_flash``: the forward kernel that also writes each row's
log-sum-exp, and the hand-written backward kernel (or, on the CPU, the
plain pair).  Single-token attention against the cache
(:func:`decode_attention`) is plain torch, as the JAX package's is jnp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch

from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ops, ref

Params = Mapping[str, torch.Tensor]
IMPLS = ("cuda", "torch")


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (a torch dtype passes through)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


def _weak(x: torch.Tensor, value: float) -> torch.Tensor:
    """A Python float as JAX treats it beside an array: in the array's
    dtype."""
    return torch.tensor(value, dtype=x.dtype)


# --------------------------------------------------------------------------
# initialisation helpers
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(torch_dtype(dtype))


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(torch_dtype(dtype))


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------


def norm_init(d: int, kind: str, dtype, device=None) -> dict:
    dt = torch_dtype(dtype)
    if kind == "rmsnorm":                         # gemma-style (1 + scale)
        return {"scale": torch.zeros((d,), dtype=dt, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dt, device=device),
                "bias": torch.zeros((d,), dtype=dt, device=device)}
    raise ValueError(kind)


def norm_apply(p: Params, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """Statistics accumulate in f32; the apply stays in x's dtype."""
    d = x.shape[-1]
    if kind == "rmsnorm":
        xf = x.float()
        var = (xf * xf).sum(-1) / d
        scale = torch.rsqrt(var + eps)[..., None].to(x.dtype)
        return x * scale * (1.0 + p["scale"]).to(x.dtype)
    if kind != "layernorm":
        raise ValueError(kind)
    mu = x.float().sum(-1) / d
    xc = x - mu[..., None].to(x.dtype)
    xcf = xc.float()
    var = (xcf * xcf).sum(-1) / d
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return xc * inv * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)


# --------------------------------------------------------------------------
# rotary / sinusoidal position embeddings
# --------------------------------------------------------------------------


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Apply RoPE. x: (B, S, H, D) with even D; positions: (B, S) or (S,)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freq                # (B, S, half)
    # cos/sin in the stream dtype before the multiply, as the JAX layer
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    half = d // 2
    freq = 10_000.0 ** (-torch.arange(half, dtype=torch.float32,
                                      device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_model: int
    rope_theta: float = 10_000.0
    window: int = 0                 # 0 = global causal
    softcap: float = 0.0            # attention-logit softcap (gemma2)
    use_rope: bool = True
    dtype: Any = torch.bfloat16


def attn_init(gen: torch.Generator, s: AttnSpec) -> dict:
    return {
        "wq": dense_init(gen, s.d_model, s.n_heads * s.head_dim, s.dtype),
        "wk": dense_init(gen, s.d_model, s.n_kv_heads * s.head_dim, s.dtype),
        "wv": dense_init(gen, s.d_model, s.n_kv_heads * s.head_dim, s.dtype),
        "wo": dense_init(gen, s.n_heads * s.head_dim, s.d_model, s.dtype),
    }


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(logits / cap) * cap if cap > 0 else logits


def qkv(p: Params, s: AttnSpec, x: torch.Tensor, positions: torch.Tensor):
    b, sq, _ = x.shape
    q = (x @ p["wq"]).reshape(b, sq, s.n_heads, s.head_dim)
    k = (x @ p["wk"]).reshape(b, sq, s.n_kv_heads, s.head_dim)
    v = (x @ p["wv"]).reshape(b, sq, s.n_kv_heads, s.head_dim)
    if s.use_rope:
        q = rope(q, positions, s.rope_theta)
        k = rope(k, positions, s.rope_theta)
    return q, k, v


class _Flash(torch.autograd.Function):
    """Attention of q already scaled by ``1/sqrt(D)``, differentiable: the
    port of the JAX ``_flash`` custom VJP (``src/repro/models/layers.py``).

    The forward runs the flash forward with its log-sum-exp and saves
    ``(qs, k, v, o, lse)``; the backward recomputes the softmax from them
    (the JAX ``_flash_vjp_bwd``) and returns dqs, dk and dv.  ``kernel``:
    the CUDA kernel pair, else the plain pair of ``kernels.ref``.
    """

    @staticmethod
    def forward(ctx, qs, k, v, window: int, softcap: float, kernel: bool):
        kw = dict(window=window, softcap=softcap)
        if kernel:
            out, lse = _flash.flash_attention_fwd(qs, k, v, with_lse=True,
                                                  **kw)
        else:
            out, lse = ref.flash_attention_fwd_ref(qs, k, v, **kw)
        ctx.save_for_backward(qs, k, v, out, lse)
        ctx.kw, ctx.kernel = kw, kernel
        return out

    @staticmethod
    def backward(ctx, do):
        qs, k, v, out, lse = ctx.saved_tensors
        bwd = (_flash.flash_attention_bwd if ctx.kernel
               else ref.flash_attention_bwd_ref)
        dq, dk, dv = bwd(qs, k, v, out, do, lse, **ctx.kw)
        return dq, dk, dv, None, None, None


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, spec: AttnSpec, q_offset: int = 0,
                        impl: str | None = None) -> torch.Tensor:
    """(B, Sq, H, D) causal GQA attention with the spec's window and
    softcap: the function of the JAX ``blockwise_attention`` (whose chunk
    sizes change no result, so the port has none).

    ``impl=None`` picks by device: the flash kernel on a CUDA tensor, the
    plain version on a CPU tensor; ``"cuda"``/``"torch"`` pin one.  Only
    ``q_offset=0`` (the prefill, and training) is supported.

    Where autograd records the call it goes through :class:`_Flash`, with
    q scaled outside it by an ordinary multiply, so that dq is rounded as
    the JAX package's (a bf16 multiply outside its custom VJP) is.
    """
    if int(q_offset) != 0:
        raise NotImplementedError("blockwise_attention: q_offset must be 0 "
                                  "(the full-sequence prefill and training)")
    if impl not in (None, *IMPLS):
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    kw = dict(window=spec.window, softcap=spec.softcap)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        kernel = impl == "cuda" or (impl is None and ops.is_cuda(q))
        return _Flash.apply(_flash.scale_query(q), k, v, spec.window,
                            spec.softcap, kernel)
    if impl is None:
        return ops.flash_attention(q, k, v, **kw)
    if impl == "cuda":
        return _flash.flash_attention(q, k, v, **kw)
    return ref.flash_attention_ref(q, k, v, **kw)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     spec: AttnSpec) -> torch.Tensor:
    """Single-token attention against a KV cache: q (B, 1, H, D), caches
    (B, S, KV, D), ``pos`` int (B,) the per-row position of the new token
    (continuous batching)."""
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    g = h // kv
    pos = torch.broadcast_to(torch.as_tensor(pos, device=q.device), (b,))
    qg = (q.reshape(b, kv, g, d) / _weak(q, math.sqrt(d))).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    logits = _softcap(logits, spec.softcap)
    k_pos = torch.arange(s, device=q.device)
    mask = k_pos[None, :] <= pos[:, None]                     # (B, S)
    if spec.window > 0:
        mask &= k_pos[None, :] > (pos[:, None] - spec.window)
    logits = torch.where(mask[:, None, None, :], logits, ref.MASKED)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out / p.sum(-1)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


# --------------------------------------------------------------------------
# gated MLP
# --------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def mlp_apply(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    a = x @ p["w_gate"]
    if act == "silu":
        a = torch.nn.functional.silu(a.float()).to(x.dtype)
    elif act == "gelu":
        a = torch.nn.functional.gelu(a.float(), approximate="tanh"
                                     ).to(x.dtype)
    else:
        raise ValueError(act)
    return (a * (x @ p["w_up"])) @ p["w_down"]
