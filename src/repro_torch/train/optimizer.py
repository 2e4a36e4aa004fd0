"""AdamW written out on tensors: the port of ``repro.train.optimizer``.

Moments are kept in float32 whatever the parameters' dtype (bf16
parameters get an f32 update, then are cast back), with global-norm
clipping, bias correction, decoupled weight decay and a warmup + cosine
schedule, all as the JAX package computes them.  ``torch.optim`` is not
used.

The JAX function returns new trees; here the update is in place, leaf by
leaf, so that a leaf's f32 temporaries live only while it is updated: at
most three at a time (the scaled gradient, the step, the f32 parameter),
2.7 GB each for gemma3_4b's 262,144 x 2,560 embedding.  Leaves are
mappings from a name to a tensor; ``grads``, ``m``, ``v`` and ``params``
share the names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

Leaves = Mapping[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def lr_at(cfg: AdamWConfig, step: int) -> float:
    """The learning rate of step ``step``: linear warmup, then a cosine down
    to ``min_lr_ratio * lr``; in f32, as the JAX function computes it."""
    s = _f32(step)
    if step < cfg.warmup_steps:
        return float(cfg.lr * s / max(cfg.warmup_steps, 1))
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    return float(cfg.lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                           * (1 + torch.cos(math.pi * t))))


def init_moments(params: Leaves) -> tuple[dict, dict]:
    """Zero f32 first and second moments beside each parameter."""
    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in params.items()}
    return zeros(), zeros()


def global_norm(grads: Leaves) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares."""
    return torch.sqrt(torch.stack(
        [torch.square(g.float()).sum() for g in grads.values()]).sum())


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its parameter (a partial sum
    reduce-scattered onto a ZeRO-3 shard); any other passes through."""
    from repro_torch.kernels._dtensor import is_dtensor
    if is_dtensor(g) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


@torch.no_grad()
def adamw_update(grads: Leaves, m: Leaves, v: Leaves, params: Leaves,
                 step: int, cfg: AdamWConfig) -> dict:
    """One AdamW step at ``step`` (0-based): ``params``, ``m`` and ``v``
    are updated in place.  Returns the stats ``grad_norm`` (a 0-d f32
    tensor on the gradients' device) and ``lr``."""
    grads = {k: _like(grads[k], p) for k, p in params.items()}
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)
    lr = lr_at(cfg, step)
    count = _f32(step) + 1.0
    bc1 = float(1.0 - _f32(cfg.b1) ** count)
    bc2 = float(1.0 - _f32(cfg.b2) ** count)
    for k, p in params.items():
        g = grads[k].to(torch.float32, copy=True).mul_(scale)
        m[k].mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v[k].mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        denom = torch.div(v[k], bc2, out=g).sqrt_().add_(cfg.eps)
        update = torch.div(m[k], bc1).div_(denom)
        del g, denom
        p_f = p.float()                     # p itself when p is f32
        update.add_(p_f, alpha=cfg.weight_decay)
        p_f.sub_(update, alpha=lr)
        if p_f is not p:
            p.copy_(p_f)
    return dict(grad_norm=gnorm, lr=lr)
