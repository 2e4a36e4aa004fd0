"""Decoder stack of the port: global/local attention blocks with a dense
gated MLP.

The port of ``repro.models.transformer``.  The JAX package stacks equal
pattern positions under one ``lax.scan`` over cycles; here the stack is an
``nn.Module`` with one :class:`DecoderLayer` per layer, run by a plain loop
(layer ``i`` has kind ``cfg.block_kind(i)``).  Two full-sequence modes share
the weights: :meth:`Transformer.forward`, the serving forward (no autograd,
optionally capturing the cache), and :meth:`Transformer.forward_train`, the
loss path, with the JAX remat policy: each whole cycle of
``len(block_pattern)`` layers is rematerialised in the backward
(``torch.utils.checkpoint``), the tail layers that fill no cycle are not.
Block kinds ``rwkv`` and ``rglru`` and MoE feed-forwards raise
``NotImplementedError``; they are never skipped.

Weights keep the JAX ``(d_in, d_out)`` orientation; :func:`params_from_jax`
copies a JAX param tree (as numpy arrays) into the stack.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import NOT_PORTED, ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.models import layers
from repro_torch.models.layers import AttnSpec

ATTN_KINDS = ("global", "local")


def attn_spec(cfg: ModelConfig, kind: str) -> AttnSpec:
    return AttnSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        d_model=cfg.d_model, rope_theta=cfg.rope_theta,
        window=cfg.window if kind == "local" else 0,
        softcap=cfg.attn_softcap, use_rope=(cfg.pos == "rope"),
        dtype=layers.torch_dtype(cfg.dtype))


def n_cycles(cfg: ModelConfig) -> tuple[int, int]:
    p = len(cfg.block_pattern)
    return cfg.n_layers // p, cfg.n_layers % p


def check_ported(cfg: ModelConfig) -> None:
    """Raise on a block kind or feed-forward the port does not have."""
    for kind in dict.fromkeys(cfg.block_kind(i) for i in range(cfg.n_layers)):
        if kind not in ATTN_KINDS:
            raise NotImplementedError(
                f"{cfg.name}: block kind {kind!r} is not ported; see "
                f"{NOT_PORTED}")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE feed-forward is not "
                                  f"ported; see {NOT_PORTED}")
    if cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} frontend "
                                  f"is not ported; see {NOT_PORTED}")


def _pdict(tensors: Mapping[str, torch.Tensor]) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v) for k, v in tensors.items()})


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: attention of ``kind`` then the MLP."""

    def __init__(self, cfg: ModelConfig, kind: str, p: Mapping[str, Any]):
        super().__init__()
        if kind not in ATTN_KINDS:
            raise NotImplementedError(f"block kind {kind!r} is not ported; "
                                      f"see {NOT_PORTED}")
        self.cfg, self.kind = cfg, kind
        self.spec = attn_spec(cfg, kind)
        self.norm1 = _pdict(p["norm1"])
        self.attn = _pdict(p["attn"])
        self.norm2 = _pdict(p["norm2"])
        self.mlp = _pdict(p["mlp"])

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                capture: bool = False, impl: str | None = None):
        """(x, cache entry): the entry holds the layer's k, v (local: the
        last ``window`` positions) when ``capture``, else it is empty."""
        cfg = self.cfg
        h = layers.norm_apply(self.norm1, x, cfg.norm)
        q, k, v = layers.qkv(self.attn, self.spec, h, positions)
        o = layers.blockwise_attention(q, k, v, spec=self.spec, q_offset=0,
                                       impl=impl)
        x = x + (o.reshape(*o.shape[:2], -1) @ self.attn["wo"])
        entry: dict[str, torch.Tensor] = {}
        if capture:
            if self.kind == "local":
                w = min(cfg.window, k.shape[1])
                entry = {"k": k[:, -w:], "v": v[:, -w:]}
            else:
                entry = {"k": k, "v": v}
        y = layers.norm_apply(self.norm2, x, cfg.norm)
        x = x + layers.mlp_apply(self.mlp, y, cfg.act)
        return x, entry


class Transformer(nn.Module):
    """Embedding, ``cfg.n_layers`` decoder layers, final norm, unembedding.

    Every parameter is trainable; the serving entry points (``forward``,
    ``model.prefill``, ``kvcache.decode_step``) run without autograd.
    """

    def __init__(self, cfg: ModelConfig, p: Mapping[str, Any]):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embed = nn.Parameter(p["embed"])
        self.final_norm = _pdict(p["final_norm"])
        self.lm_head = (None if cfg.tie_embeddings
                        else nn.Parameter(p["lm_head"]))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, cfg.block_kind(i), lp)
            for i, lp in enumerate(p["layers"]))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding: its backward adds the rows' gradients without
        # atomics (an index's adds in a fixed order), so steps repeat bitwise
        x = F.embedding(tokens.long(), self.embed)
        if self.cfg.pos == "sinusoidal":
            pos = torch.arange(tokens.shape[1], device=tokens.device)
            x = x + layers.sinusoidal(pos, self.cfg.d_model)[None].to(x.dtype)
        return x

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor, *, capture_cache: bool = False,
                impl: str | None = None):
        """Full-sequence forward of ``tokens`` (B, S).  Returns (hidden
        after the final norm, per-layer cache entries in layer order, empty
        unless ``capture_cache``)."""
        x = self.embed_tokens(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        entries = []
        for layer in self.layers:
            x, e = layer(x, positions, capture=capture_cache, impl=impl)
            if capture_cache:
                entries.append(e)
        x = layers.norm_apply(self.final_norm, x, self.cfg.norm)
        return x, entries

    def _cycle(self, x: torch.Tensor, positions: torch.Tensor, first: int,
               impl: str | None) -> torch.Tensor:
        for layer in self.layers[first:first + len(self.cfg.block_pattern)]:
            x, _ = layer(x, positions, impl=impl)
        return x

    def forward_train(self, tokens: torch.Tensor, *, remat: bool = True,
                      impl: str | None = None) -> torch.Tensor:
        """Full-sequence forward of ``tokens`` (B, S) for the loss: the
        hidden state after the final norm, recorded by autograd.

        ``remat`` is the JAX ``remat``: each of the ``n_cycles`` whole
        cycles is one ``torch.utils.checkpoint`` (non-reentrant), so the
        backward recomputes it from its input and keeps none of its
        activations; the tail layers keep theirs.  The attention forward
        then runs twice for every layer of a cycle and once for a tail
        layer.
        """
        x = self.embed_tokens(tokens)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        pat = len(self.cfg.block_pattern)
        nc, _ = n_cycles(self.cfg)
        for c in range(nc):
            if remat:
                x = checkpoint(self._cycle, x, positions, c * pat, impl,
                               use_reentrant=False)
            else:
                x = self._cycle(x, positions, c * pat, impl)
        for layer in self.layers[nc * pat:]:
            x, _ = layer(x, positions, impl=impl)
        return layers.norm_apply(self.final_norm, x, self.cfg.norm)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        logits = x @ w
        cap = self.cfg.logit_softcap
        if cap > 0:
            logits = torch.tanh(logits / cap) * cap
        return logits


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    dt = layers.torch_dtype(cfg.dtype)
    return {"norm1": layers.norm_init(cfg.d_model, cfg.norm, dt, gen.device),
            "norm2": layers.norm_init(cfg.d_model, cfg.norm, dt, gen.device),
            "attn": layers.attn_init(gen, attn_spec(cfg, kind)),
            "mlp": layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dt)}


def init(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random weights on the generator's device, drawn in this order: the
    embedding, the unembedding, then per layer wq, wk, wv, wo, w_gate,
    w_up, w_down.  The stream is not ``jax.random``'s: weights that must
    equal the JAX model's come through :func:`params_from_jax`."""
    check_ported(cfg)
    dt = layers.torch_dtype(cfg.dtype)
    p: dict[str, Any] = {
        "embed": layers.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "final_norm": layers.norm_init(cfg.d_model, cfg.norm, dt, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = layers.dense_init(gen, cfg.d_model, cfg.vocab_size, dt)
    p["layers"] = [_init_layer(gen, cfg, cfg.block_kind(i))
                   for i in range(cfg.n_layers)]
    return Transformer(cfg, p)


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device=None) -> Transformer:
    """The port's stack holding the weights of a JAX param tree.

    ``tree`` is ``repro.models.transformer.init``'s tree with numpy leaves
    (bf16 leaves may be ml_dtypes arrays): ``embed``, ``final_norm``,
    ``lm_head`` (untied), ``scan`` (a tuple over pattern positions, each
    leaf with a leading ``n_cycles`` axis) and ``tail``.  Layer
    ``c * P + j`` takes ``scan[j][c]``, then come the tail's layers.
    ``device=None`` means the card.
    """
    check_ported(cfg)
    dev = resolve_device(device)
    dt = layers.torch_dtype(cfg.dtype)

    def conv(a):
        return torch.from_numpy(np.array(a, np.float32)).to(dev, dt)

    def conv_tree(t, index=None):
        if isinstance(t, Mapping):
            return {k: conv_tree(v, index) for k, v in t.items()}
        return conv(t if index is None else np.asarray(t)[index])

    pat = len(cfg.block_pattern)
    nc, rem = n_cycles(cfg)
    p: dict[str, Any] = {"embed": conv(tree["embed"]),
                         "final_norm": conv_tree(tree["final_norm"])}
    if not cfg.tie_embeddings:
        p["lm_head"] = conv(tree["lm_head"])
    p["layers"] = [conv_tree(tree["scan"][j], c)
                   for c in range(nc) for j in range(pat)]
    p["layers"] += [conv_tree(tree["tail"][j]) for j in range(rem)]
    return Transformer(cfg, p)
