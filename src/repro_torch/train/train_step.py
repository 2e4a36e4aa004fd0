"""The training step: loss, gradients and AdamW, with optional gradient
accumulation.  The port of ``repro.train.train_step``.

:class:`TrainState` holds the parameters (a ``Transformer`` or a mapping
from names to tensors), the f32 moments by the same names and the step.  A
step updates the state in place and returns it: on the card the state is
most of the memory (12 bytes a parameter), so it is never copied.
Gradient accumulation runs the microbatches one after the other with f32
accumulators, each microbatch's gradient divided by ``grad_accum``, as the
JAX ``lax.scan`` does; the peak then holds one microbatch's activations.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch
from torch import nn

from repro_torch.train import optimizer as opt


@dataclasses.dataclass
class TrainState:
    params: Any            # nn.Module, or a mapping name -> tensor
    m: dict
    v: dict
    step: int = 0


def named_params(params) -> dict[str, torch.Tensor]:
    """The trainable leaves by name: a module's named parameters, or the
    mapping itself."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init_state(params) -> TrainState:
    """Zero moments and step 0; every leaf of ``params`` requires grad."""
    leaves = named_params(params)
    for p in leaves.values():
        p.requires_grad_(True)
    m, v = opt.init_moments(leaves)
    return TrainState(params=params, m=m, v=v, step=0)


def _split(batch: Mapping, n: int) -> list[dict]:
    """``n`` microbatches of consecutive rows (the JAX reshape to
    ``(n, B / n, ...)``)."""
    out = []
    for i in range(n):
        mb = {}
        for k, x in batch.items():
            if x.shape[0] % n:
                raise ValueError(f"batch of {x.shape[0]} rows does not split "
                                 f"into {n} microbatches")
            rows = x.shape[0] // n
            mb[k] = x[i * rows:(i + 1) * rows]
        out.append(mb)
    return out


def make_train_step(loss_fn: Callable, cfg: opt.AdamWConfig, *,
                    grad_accum: int = 1) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics dict)``, with autograd on.
    Returns ``train_step(state, batch) -> (state, metrics)``: the metrics
    of the loss (averaged over microbatches) and ``grad_norm``, ``lr``."""

    def compute_grads(params, batch):
        leaves = named_params(params)
        if grad_accum == 1:
            loss, metrics = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            metrics = {k: x.detach() for k, x in metrics.items()}
            return loss.detach(), metrics, dict(zip(leaves, grads))
        acc = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for k, p in leaves.items()}
        metrics_acc: dict[str, torch.Tensor] = {}
        for mb in _split(batch, grad_accum):
            loss, metrics = loss_fn(params, mb)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            for a, g in zip(acc.values(), grads):
                a.add_(g.float() / grad_accum)
            del grads
            for k, x in metrics.items():
                part = x.detach().float() / grad_accum
                metrics_acc[k] = (metrics_acc[k] + part if k in metrics_acc
                                  else torch.zeros_like(part) + part)
        return metrics_acc["loss"], metrics_acc, acc

    def train_step(state: TrainState, batch) -> tuple[TrainState, dict]:
        _, metrics, grads = compute_grads(state.params, batch)
        stats = opt.adamw_update(grads, state.m, state.v,
                                 named_params(state.params), state.step, cfg)
        del grads
        state.step += 1
        return state, {**metrics, **stats}

    return train_step
