"""Public model API of the port: ``build_model(cfg)`` -> init / loss_fn /
prefill / decode_step / init_cache.

The port of ``repro.models.model``.  The loss path uses the JAX package's
sequence-chunked cross-entropy: the (B, S, V) logits are never made whole;
each chunk's f32 logits are recomputed in the backward
(``torch.utils.checkpoint`` per chunk, as the JAX ``jax.checkpoint``).  At
gemma3_4b's 262,144-token vocabulary and B = 2, S = 4,096 whole logits
would hold 8.6 GB.  ``frontends`` is not needed by the ported architectures.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import kvcache, layers, transformer


IGNORE_ID = -100
CE_CHUNK = 512


def _chunk_loss(xi: torch.Tensor, li: torch.Tensor, unembed_fn: Callable
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed cross-entropy and token count of one chunk (B, c, D)."""
    logits = unembed_fn(xi).float()                          # (B, c, V)
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, torch.clamp_min(li, 0)[..., None].long())[..., 0]
    mask = (li != IGNORE_ID).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(x: torch.Tensor, unembed_fn: Callable,
                          labels: torch.Tensor, *, chunk: int = CE_CHUNK
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over the tokens whose label is not :data:`IGNORE_ID`, and
    their count (f32), ``chunk`` positions at a time.  Under autograd each
    chunk is a checkpoint: its logits are made again in the backward rather
    than kept."""
    b, s, _ = x.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq_len {s} must divide by the CE chunk {chunk}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        xi, li = x[:, c0:c0 + chunk], labels[:, c0:c0 + chunk]
        if torch.is_grad_enabled() and x.requires_grad:
            loss, n = checkpoint(_chunk_loss, xi, li, unembed_fn,
                                 use_reentrant=False)
        else:
            loss, n = _chunk_loss(xi, li, unembed_fn)
        tot, cnt = tot + loss, cnt + n
    return tot / torch.clamp_min(cnt, 1.0), cnt


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., transformer.Transformer]
    loss_fn: Callable[..., tuple[torch.Tensor, dict]]
    prefill: Callable[..., tuple[torch.Tensor, list]]
    decode_step: Callable[..., tuple[torch.Tensor, list]]
    init_cache: Callable[..., list]


def build_model(cfg: ModelConfig, *, impl: str | None = None) -> Model:
    """``impl`` is the attention of the prefill and the loss (forward and
    backward): None picks by the weights' device (the flash kernels on the
    card, their plain versions on the CPU); ``"cuda"`` or ``"torch"`` pins
    one."""
    transformer.check_ported(cfg)
    if impl not in (None, *layers.IMPLS):
        raise ValueError(f"unknown impl {impl!r}; expected None or one of "
                         f"{layers.IMPLS}")

    def init(generator: torch.Generator | None = None):
        """Random weights from ``generator``, on its device (None: seed 0
        on the card; raises without one)."""
        if generator is None:
            generator = torch.Generator(resolve_device())
            generator.manual_seed(0)
        return transformer.init(generator, cfg)

    def loss_fn(params: transformer.Transformer, batch, *,
                remat: bool = True) -> tuple[torch.Tensor, dict]:
        """(mean CE, metrics) of ``batch`` {"tokens", "labels"} (B, S), with
        autograd on: ``loss.backward()`` or ``torch.autograd.grad`` gives the
        parameters' gradients.  Labels are taken as they are: the JAX
        ``frontends.mask_frontend_labels`` is the identity for every ported
        config (none has a frontend)."""
        tokens = torch.as_tensor(batch["tokens"], device=params.device)
        labels = torch.as_tensor(batch["labels"], device=params.device)
        x = params.forward_train(tokens, remat=remat, impl=impl)
        loss, n_tok = chunked_cross_entropy(x, params.unembed, labels)
        return loss, dict(loss=loss, n_tokens=n_tok)

    @torch.no_grad()
    def prefill(params: transformer.Transformer, tokens, *,
                max_seq: int | None = None):
        """Last-position logits (B, V) and a fresh cache of ``max_seq``
        positions holding the prompt."""
        tokens = torch.as_tensor(tokens, device=params.device)
        b, s = tokens.shape
        max_seq = max_seq or s
        x, entries = params(tokens, capture_cache=True, impl=impl)
        cache = kvcache.init_cache(cfg, b, max_seq, params.device)
        cache = kvcache.prefill_to_cache(cfg, entries, cache, s)
        logits = params.unembed(x[:, -1:])[:, 0]
        return logits, cache

    def decode_step(params, cache, token, pos):
        return kvcache.decode_step(params, cfg, cache, token, pos)

    def init_cache(batch: int, max_seq: int, device=None):
        return kvcache.init_cache(cfg, batch, max_seq, device)

    return Model(cfg=cfg, init=init, loss_fn=loss_fn, prefill=prefill,
                 decode_step=decode_step, init_cache=init_cache)
