"""Public model API of the port: ``build_model(cfg)`` -> init / prefill /
decode_step / init_cache.

The port of ``repro.models.model`` for serving.  Training (``loss_fn`` and
the chunked cross-entropy) comes with the LM training path (ROADMAP);
``frontends`` is not needed by the ported architectures.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import kvcache, layers, transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., transformer.Transformer]
    prefill: Callable[..., tuple[torch.Tensor, list]]
    decode_step: Callable[..., tuple[torch.Tensor, list]]
    init_cache: Callable[..., list]


def build_model(cfg: ModelConfig, *, impl: str | None = None) -> Model:
    """``impl`` is the prefill's attention: None picks by the weights'
    device (the flash kernel on the card, its plain version on the CPU);
    ``"cuda"`` or ``"torch"`` pins one."""
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

    return Model(cfg=cfg, init=init, prefill=prefill,
                 decode_step=decode_step, init_cache=init_cache)
