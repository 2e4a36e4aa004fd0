"""Mixture-of-Experts feed-forward with gather-based dispatch.

The port of ``repro.models.moe``: route with data movement, not one-hot
products.

  1. token top-k over the f32 router's softmax (standard softmax gating);
  2. per-expert **top-C token selection** on the renormalised gate scores,
     C = min(max(8, ceil(T·k/E · 1.25)), T); tokens past an expert's
     capacity are dropped (combine weight 0), empty slots are masked;
  3. a gather to (E, C, D), the grouped FFN as three ``torch.bmm`` (the JAX
     package's ``einsum``), and a gate-weighted ``index_add`` combine.

Both top-k are a stable descending sort: ``jax.lax.top_k`` takes the lowest
index first among equal values and ``torch.topk`` promises no order.  The
order decides which tokens an expert keeps at overflow: every llama4_scout
gate is exactly 1.0 (top-1, renormalised), and the unrouted tokens' zero
scores tie too.  The expert-major tensors are pinned by
``sharding.act.shard_experts`` where the JAX package pins them (the
identity on one device; on a mesh, E over TP and with ``moe2d`` the
capacity axis over DP).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from repro_torch.models import layers
from repro_torch.sharding.act import replicate, shard_experts

Params = Mapping[str, Any]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    d_model: int
    d_ff: int
    n_experts: int
    experts_per_token: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    act: str = "silu"
    dtype: Any = torch.bfloat16


def moe_init(gen: torch.Generator, s: MoESpec) -> dict:
    """Drawn in this order: router (f32, kept f32), w_gate, w_up, w_down,
    then the shared expert's MLP."""
    scale = 1.0 / math.sqrt(s.d_model)

    def draw(shape):
        return torch.randn(shape, generator=gen, device=gen.device,
                           dtype=torch.float32) * scale

    e, d, f = s.n_experts, s.d_model, s.d_ff
    dt = layers.torch_dtype(s.dtype)
    p = {"router": draw((d, e)),
         "w_gate": draw((e, d, f)).to(dt),
         "w_up": draw((e, d, f)).to(dt),
         "w_down": draw((e, f, d)).to(dt)}
    if s.n_shared_experts:
        p["shared"] = layers.mlp_init(gen, d, f * s.n_shared_experts, dt)
    return p


def capacity(n_tokens: int, s: MoESpec) -> int:
    c = math.ceil(n_tokens * s.experts_per_token / s.n_experts
                  * s.capacity_factor)
    return min(max(8, c), n_tokens)


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, ties to the
    lowest index."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def route(p: Params, xf: torch.Tensor, s: MoESpec):
    """The routing of tokens ``xf`` (T, D): the router's softmax (T, E),
    each token's top-k experts (T, k), and each expert's top-C gate scores
    and token indices (E, C)."""
    logits = xf.float() @ p["router"]                            # (T, E)
    # replicated under DTensor: the routing's sorts and gathers need whole
    # rows and columns (a gather from an E-split row is a masked partial
    # that DTensor cannot use twice)
    probs = replicate(torch.softmax(logits, -1))
    top_p, top_e = top_k(probs, s.experts_per_token)             # (T, k)
    # combine weight of (token, expert): the top-k gate prob, renormalised
    gate = torch.zeros(probs.shape, dtype=torch.float32,
                       device=xf.device).scatter(
        1, top_e, top_p / top_p.sum(-1, keepdim=True))
    # per-expert top-C token selection on the gate score (its gradient,
    # E-split by the experts' layout, replicated back into the routing)
    sel_score, sel_idx = top_k(gate.T, capacity(xf.shape[0], s))
    return probs, top_e, replicate(sel_score), sel_idx


def moe_apply(p: Params, x: torch.Tensor, s: MoESpec
              ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """x: (B, S, D) -> (out, aux): ``moe_aux``, the Switch load-balance
    loss, and ``moe_dropped``, the share of empty or dropped expert
    slots."""
    b, seq, d = x.shape
    t = b * seq
    xf = x.reshape(t, d)
    dt = layers.torch_dtype(s.dtype)
    probs, top_e, sel_score, sel_idx = route(p, xf, s)
    live = sel_score > 0.0                                       # (E, C)
    flat = sel_idx.reshape(-1)
    xg = xf[flat].reshape(s.n_experts, -1, d)
    xg = shard_experts(torch.where(live[..., None], xg, 0).to(dt))

    a = shard_experts(torch.bmm(xg, p["w_gate"]))
    if s.act == "silu":
        a = F.silu(a.float()).to(dt)
    else:                                  # jax.nn.gelu: the tanh form
        a = F.gelu(a.float(), approximate="tanh").to(dt)
    h = a * torch.bmm(xg, p["w_up"])
    y = shard_experts(torch.bmm(h, p["w_down"]))                 # (E, C, D)

    y = y.float() * sel_score[..., None] * live[..., None]
    # A token's adds are at most two non-zero values (top-1 or top-2 in
    # every config) and exact zeros (its unrouted and dropped slots), and
    # IEEE addition of two values commutes, so the sum does not depend on
    # the order the device adds in.
    # replicated under DTensor: no index_add strategy scatters E-sharded
    # rows into token rows
    out = torch.zeros((t, d), dtype=torch.float32,
                      device=x.device).index_add(
        0, replicate(flat), replicate(y.reshape(-1, d)))
    if s.n_shared_experts:
        out = out + layers.mlp_apply(p["shared"], xf, s.act).float()

    me = probs.mean(0)                                           # (E,)
    frac = F.one_hot(top_e, s.n_experts).sum((0, 1)) / (
        t * s.experts_per_token)
    aux = s.n_experts * (me * frac).sum()
    stats = dict(moe_aux=aux, moe_dropped=1.0 - live.float().mean())
    return out.reshape(b, seq, d).to(x.dtype), stats
