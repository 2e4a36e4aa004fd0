"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The port of ``repro.models.rglru``.  Recurrence (per channel):

    r_t = sigmoid(W_a x_t + b_a)            # recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            # input gate
    a_t = exp(-c * softplus(Lambda) * r_t)  # data-dependent decay, c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates' products run in f32 (the JAX ``_gates``), so TF32 must stay off
for them on the card (``torch.backends.cuda.matmul.allow_tf32``, False by
default).  The linear recurrence is a log-depth scan over the sequence
(:func:`rglru_scan`, doubling: ceil(log2 S) rounds of elementwise torch),
the JAX package's ``associative_scan``.  Wrapped in the Griffin block: a
causal depthwise conv over the recurrent branch and a GeLU gate branch
(the tanh form, as ``jax.nn.gelu(approximate=True)``).

:func:`rglru_step` carries (h, conv window) for O(1) decode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import torch
import torch.nn.functional as F

from repro_torch.models import layers

Params = Mapping[str, torch.Tensor]
_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_model: int
    lru_width: int
    conv_width: int = 4
    dtype: Any = torch.bfloat16


def rglru_init(gen: torch.Generator, s: RGLRUSpec) -> dict:
    """Drawn in this order: u (for log_lambda), w_in, w_gate_branch, w_out,
    conv_w, wa, wx.  ba, bx and log_lambda are f32, as in the JAX init."""
    dt = layers.torch_dtype(s.dtype)
    dev = gen.device
    scale = 1.0 / math.sqrt(s.d_model)

    def lin(di, do):
        w = torch.randn((di, do), generator=gen, device=dev,
                        dtype=torch.float32)
        return (w * scale).to(dt)

    # Lambda so that a^c spreads decays across [0.9, 0.999] (the paper)
    u = torch.rand((s.lru_width,), generator=gen, device=dev,
                   dtype=torch.float32) * (0.999 - 0.9) + 0.9
    log_lambda = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1
    w = s.lru_width
    p = {"w_in": lin(s.d_model, w), "w_gate_branch": lin(s.d_model, w),
         "w_out": lin(w, s.d_model)}
    p["conv_w"] = (torch.randn((s.conv_width, w), generator=gen, device=dev,
                               dtype=torch.float32) * 0.1).to(dt)
    p["conv_b"] = torch.zeros((w,), dtype=dt, device=dev)
    p["wa"] = lin(w, w)
    p["ba"] = torch.zeros((w,), dtype=torch.float32, device=dev)
    p["wx"] = lin(w, w)
    p["bx"] = torch.zeros((w,), dtype=torch.float32, device=dev)
    p["log_lambda"] = log_lambda
    return p


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv1d. x: (B, S, W); w: (K, W)."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                       device=x.device)
           if state is None else state.to(x.dtype))
    xp = torch.cat([pad, x], 1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(k))
    return out + b


def _gates(p: Params, u: torch.Tensor):
    uf = u.float()
    r = torch.sigmoid(uf @ p["wa"].float() + p["ba"])
    i = torch.sigmoid(uf @ p["wx"].float() + p["bx"])
    log_a = -_C * F.softplus(p["log_lambda"]) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)
                       ) * (i * uf)
    return a, gated


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1 (h_{-1} = 0), in ceil(log2 S)
    doubling rounds: after the round of ``shift``, each position holds the
    composition of the ``2 * shift`` steps ending there."""
    seq = a.shape[1]
    shift = 1
    while shift < seq:
        a_hi, b_hi = a[:, shift:], b[:, shift:]
        b = torch.cat([b[:, :shift], b[:, :-shift] * a_hi + b_hi], 1)
        a = torch.cat([a[:, :shift], a[:, :-shift] * a_hi], 1)
        shift *= 2
    return b


def rglru_apply(p: Params, s: RGLRUSpec, x: torch.Tensor, *,
                return_state: bool = False):
    """Full-sequence Griffin recurrent block. x: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns (h_last, conv window) for decode.
    """
    dt = layers.torch_dtype(s.dtype)
    u = x @ p["w_in"]                                            # (B, S, W)
    uc = _causal_conv(u, p["conv_w"], p["conv_b"])
    a, gated = _gates(p, uc)
    h = rglru_scan(a, gated)                                     # (B, S, W)
    gate = F.gelu((x @ p["w_gate_branch"]).float(), approximate="tanh")
    out = (h * gate).to(dt) @ p["w_out"]
    if return_state:
        return out, h[:, -1], u[:, -(s.conv_width - 1):]
    return out


def rglru_step(p: Params, s: RGLRUSpec, x: torch.Tensor,
               h_prev: torch.Tensor, conv_state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """O(1) decode step.  x: (B, D); h_prev: (B, W); conv_state (B, K-1, W)."""
    dt = layers.torch_dtype(s.dtype)
    u = x @ p["w_in"]                                            # (B, W)
    window = torch.cat([conv_state, u[:, None]], 1)              # (B, K, W)
    uc = (window * p["conv_w"][None]).sum(1) + p["conv_b"]
    a, gated = _gates(p, uc[:, None])
    h = a[:, 0] * h_prev + gated[:, 0]                           # (B, W)
    gate = F.gelu((x @ p["w_gate_branch"]).float(), approximate="tanh")
    out = (h * gate).to(dt) @ p["w_out"]
    return out, h, window[:, 1:]
