"""Public model API of the port: ``build_model(cfg)`` -> init / loss_fn /
prefill / decode_step / init_cache.

The port of ``repro.models.model``.  The loss path uses the JAX package's
sequence-chunked cross-entropy: the (B, S, V) logits are never made whole;
each chunk's f32 logits are recomputed in the backward
(``torch.utils.checkpoint`` per chunk, as the JAX ``jax.checkpoint``).  At
gemma3_4b's 262,144-token vocabulary and B = 2, S = 4,096 whole logits
would hold 8.6 GB.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import frontends, kvcache, layers, transformer
from repro_torch.sharding.act import shard_batch, shard_batch_tp_last
from repro_torch.utils import scan as uscan


IGNORE_ID = -100
CE_CHUNK = 512


def _chunk_loss(xi: torch.Tensor, li: torch.Tensor, unembed_fn: Callable
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Summed cross-entropy and token count of one chunk (B, c, D)."""
    logits = shard_batch_tp_last(unembed_fn(xi).float())     # (B, c, V)
    lse = torch.logsumexp(logits, -1)
    # a gather from vocab-sharded logits is a masked partial sum under
    # DTensor, summed here while its mask still has the gather's shape
    gold = shard_batch(logits.gather(
        -1, torch.clamp_min(li, 0)[..., None].long()))[..., 0]
    mask = (li != IGNORE_ID).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_cross_entropy(x: torch.Tensor, unembed_fn: Callable,
                          labels: torch.Tensor, *, chunk: int = CE_CHUNK
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over the tokens whose label is not :data:`IGNORE_ID`, and
    their count (f32), ``chunk`` positions at a time (a
    :func:`repro_torch.utils.scan.scan` over the chunks, as the JAX
    function scans them).  Under autograd each chunk is a checkpoint: its
    logits are made again in the backward rather than kept."""
    b, s, _ = x.shape
    chunk = min(uscan.analysis_chunk(chunk, s), s)
    if s % chunk:
        raise ValueError(f"seq_len {s} must divide by the CE chunk {chunk}")
    n = s // chunk
    xc = x.reshape(b, n, chunk, -1).transpose(0, 1)
    lc = labels.reshape(b, n, chunk).transpose(0, 1)
    remat = torch.is_grad_enabled() and x.requires_grad

    def step(carry, inp):
        tot, cnt = carry
        if remat:
            loss, k = checkpoint(_chunk_loss, *inp, unembed_fn,
                                 use_reentrant=False)
        else:
            loss, k = _chunk_loss(*inp, unembed_fn)
        return (tot + loss, cnt + k), None

    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    (tot, cnt), _ = uscan.scan(step, (zero, zero), (xc, lc))
    return tot / torch.clamp_min(cnt, 1.0), cnt


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., transformer.Transformer]
    init_meta: Callable[[], transformer.Transformer]
    loss_fn: Callable[..., tuple[torch.Tensor, dict]]
    prefill: Callable[..., tuple[torch.Tensor, list]]
    decode_step: Callable[..., tuple[torch.Tensor, list]]
    init_cache: Callable[..., list]


def build_model(cfg: ModelConfig, *, impl: str | None = None) -> Model:
    """``impl`` is the attention of the prefill and the loss (forward and
    backward): None picks by the weights' device (the flash kernels on the
    card, their plain versions on the CPU); ``"cuda"`` or ``"torch"`` pins
    one."""
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
        """(loss, metrics) of ``batch`` {"tokens", "labels"} (B, S) and,
        where the config has them, "frontend_embeds", with autograd on:
        ``loss.backward()`` or ``torch.autograd.grad`` gives the
        parameters' gradients.  The positions the frontend occupies are
        masked out of the labels.  The loss is the mean CE plus ``0.01 *
        moe_aux`` for an MoE; the metrics hold the CE (``loss``),
        ``n_tokens`` and the MoE's ``moe_aux`` and ``moe_dropped``."""
        tokens = torch.as_tensor(batch["tokens"], device=params.device)
        labels = frontends.mask_frontend_labels(
            cfg, torch.as_tensor(batch["labels"], device=params.device),
            IGNORE_ID)
        x, aux = params.forward_train(tokens, batch.get("frontend_embeds"),
                                      remat=remat, impl=impl)
        loss, n_tok = chunked_cross_entropy(x, params.unembed, labels)
        metrics = dict(loss=loss, n_tokens=n_tok, **aux)
        if "moe_aux" in aux:
            loss = loss + 0.01 * aux["moe_aux"]
        return loss, metrics

    @torch.no_grad()
    def prefill(params: transformer.Transformer, tokens,
                frontend_embeds=None, *, max_seq: int | None = None):
        """Last-position logits (B, V) and a fresh cache of ``max_seq``
        positions holding the prompt (with the frontend's embeddings in
        its first positions, when given)."""
        tokens = torch.as_tensor(tokens, device=params.device)
        b, s = tokens.shape
        max_seq = max_seq or s
        x, entries = params(tokens, frontend_embeds, capture_cache=True,
                            impl=impl)
        cache = kvcache.init_cache_laid_out(cfg, b, max_seq, params)
        cache = kvcache.prefill_to_cache(cfg, entries, cache, s)
        logits = params.unembed(x[:, -1:])[:, 0]
        return logits, cache

    def decode_step(params, cache, token, pos):
        return kvcache.decode_step(params, cfg, cache, token, pos)

    def init_cache(batch: int, max_seq: int, device=None):
        return kvcache.init_cache(cfg, batch, max_seq, device)

    return Model(cfg=cfg, init=init,
                 init_meta=lambda: transformer.init_meta(cfg),
                 loss_fn=loss_fn, prefill=prefill, decode_step=decode_step,
                 init_cache=init_cache)
