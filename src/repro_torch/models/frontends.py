"""Modality frontend stubs: the port of ``repro.models.frontends``.

The ``vlm`` and ``audio`` configs specify the transformer backbone only; a
modality frontend supplies precomputed embeddings:

  vision: anyres patch embeddings (B, frontend_tokens, d_model), early-fused
          into the first ``frontend_tokens`` sequence positions (llava-next
          style); a deployment would put the CLIP tower and projector here.
  audio:  the token stream itself is the EnCodec codes (musicgen is
          decoder-only over them, ``frontend_tokens = 0``).

These helpers make test and smoke inputs of the right shape and dtype.  The
embeddings are numpy draws, the JAX package's own, so both packages get the
same values.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import layers


def frontend_embeds_spec(cfg: ModelConfig, batch: int):
    """(shape, torch dtype) of the frontend embeddings, or None."""
    if not cfg.frontend or not cfg.frontend_tokens:
        return None
    return ((batch, cfg.frontend_tokens, cfg.d_model),
            layers.torch_dtype(cfg.dtype))


def fake_frontend_embeds(cfg: ModelConfig, batch: int, seed: int = 0,
                         device=None) -> torch.Tensor | None:
    """N(0, 0.02) embeddings from ``np.random.default_rng(seed)`` on
    ``device`` (None: the card), or None where the config has none."""
    spec = frontend_embeds_spec(cfg, batch)
    if spec is None:
        return None
    shape, dtype = spec
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(0, 0.02, shape)).to(
        resolve_device(device), dtype)


def mask_frontend_labels(cfg: ModelConfig, labels: torch.Tensor,
                         ignore_id: int = -100) -> torch.Tensor:
    """Loss-mask the positions the frontend embeddings occupy."""
    if not cfg.frontend_tokens:
        return labels
    labels = labels.clone()
    labels[:, :cfg.frontend_tokens] = ignore_id
    return labels
