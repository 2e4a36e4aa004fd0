"""Token sampling for the serving engine."""

from __future__ import annotations

import torch


def sample(logits: torch.Tensor, generator: torch.Generator | None = None, *,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits (B, V) -> int32 tokens (B,).  temperature 0 = greedy (the
    first maximum).  Otherwise a categorical draw from ``generator`` over
    ``logits / temperature``, restricted to the ``top_k`` largest when
    ``top_k > 0``.  The draws are not ``jax.random``'s: only the support
    and the greedy choice match the JAX sampler."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits >= cutoff, logits, -torch.inf)
    # exponential race: argmax p / E with E ~ Exp(1) draws from softmax(p)
    e = torch.empty_like(logits).exponential_(generator=generator)
    return torch.argmax(torch.softmax(logits, -1) / e, dim=-1).to(
        torch.int32)
