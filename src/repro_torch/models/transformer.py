"""Decoder stack of the port over heterogeneous block patterns.

The port of ``repro.models.transformer``: each layer is dispatched on its
``block_kind`` (global/local attention, ``rwkv``, ``rglru``), with a dense
gated MLP or an MoE feed-forward (``rwkv`` layers carry their own channel
mix instead).  The JAX package stacks equal pattern positions under one
``lax.scan`` over cycles; here the stack is an ``nn.Module`` with one
:class:`DecoderLayer` per layer, run by a plain loop (layer ``i`` has kind
``cfg.block_kind(i)``).  Two full-sequence modes share the weights:
:meth:`Transformer.forward`, the serving forward (no autograd, optionally
capturing the cache), and :meth:`Transformer.forward_train`, the loss
path, with the JAX remat policy: each whole cycle of ``len(block_pattern)``
layers is rematerialised in the backward (``torch.utils.checkpoint``), the
tail layers that fill no cycle are not.  A frontend's embeddings are
early-fused into the first ``cfg.frontend_tokens`` positions.

Weights keep the JAX ``(d_in, d_out)`` orientation and each leaf's JAX
dtype (the MoE router, RG-LRU's gate biases and ``log_lambda`` and RWKV's
decay and bonus leaves are f32 in a bf16 model); :func:`params_from_jax`
copies a JAX param tree (as numpy arrays) into the stack.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.kernels._dtensor import is_dtensor
from repro_torch.models import layers, moe, rglru, rwkv6
from repro_torch.models.layers import AttnSpec
from repro_torch.sharding.act import shard_batch, shard_kv_capture

ATTN_KINDS = ("global", "local")
BLOCK_KINDS = ATTN_KINDS + ("rwkv", "rglru")


def attn_spec(cfg: ModelConfig, kind: str) -> AttnSpec:
    return AttnSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        d_model=cfg.d_model, rope_theta=cfg.rope_theta,
        window=cfg.window if kind == "local" else 0,
        softcap=cfg.attn_softcap, use_rope=(cfg.pos == "rope"),
        dtype=layers.torch_dtype(cfg.dtype))


def rwkv_spec(cfg: ModelConfig) -> rwkv6.RWKVSpec:
    return rwkv6.RWKVSpec(d_model=cfg.d_model, n_heads=cfg.n_heads,
                          d_ff=cfg.d_ff, dtype=layers.torch_dtype(cfg.dtype))


def rglru_spec(cfg: ModelConfig) -> rglru.RGLRUSpec:
    return rglru.RGLRUSpec(d_model=cfg.d_model,
                           lru_width=cfg.lru_width or cfg.d_model,
                           conv_width=cfg.conv_width,
                           dtype=layers.torch_dtype(cfg.dtype))


def moe_spec(cfg: ModelConfig) -> moe.MoESpec:
    return moe.MoESpec(d_model=cfg.d_model, d_ff=cfg.d_ff,
                       n_experts=cfg.n_experts,
                       experts_per_token=cfg.experts_per_token,
                       n_shared_experts=cfg.n_shared_experts, act=cfg.act,
                       dtype=layers.torch_dtype(cfg.dtype))


def n_cycles(cfg: ModelConfig) -> tuple[int, int]:
    p = len(cfg.block_pattern)
    return cfg.n_layers // p, cfg.n_layers % p


def _pdict(tensors: Mapping[str, Any]) -> nn.ParameterDict:
    """The JAX sub-tree as parameters; a nested mapping (the MoE's shared
    expert) becomes a nested ``ParameterDict`` of the same key."""
    return nn.ParameterDict({
        k: _pdict(v) if isinstance(v, Mapping) else nn.Parameter(v)
        for k, v in tensors.items()})


class DecoderLayer(nn.Module):
    """One pre-norm decoder layer: the block of ``kind`` (``attn``, ``tm``
    or ``rec``), then the feed-forward (``mlp`` or ``moe``; an ``rwkv``
    layer's ``tm`` holds its channel mix instead)."""

    def __init__(self, cfg: ModelConfig, kind: str, p: Mapping[str, Any]):
        super().__init__()
        if kind not in BLOCK_KINDS:
            raise ValueError(f"unknown block kind {kind!r}; expected one of "
                             f"{BLOCK_KINDS}")
        self.cfg, self.kind = cfg, kind
        self.norm1 = _pdict(p["norm1"])
        self.norm2 = _pdict(p["norm2"])
        if kind in ATTN_KINDS:
            self.spec = attn_spec(cfg, kind)
            self.attn = _pdict(p["attn"])
        elif kind == "rwkv":
            self.spec = rwkv_spec(cfg)
            self.tm = _pdict(p["tm"])
        else:
            self.spec = rglru_spec(cfg)
            self.rec = _pdict(p["rec"])
        if "moe" in p:
            self.moe = _pdict(p["moe"])
        elif "mlp" in p:
            self.mlp = _pdict(p["mlp"])

    def ffn(self, y: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """The feed-forward of ``y`` and its aux (the MoE's, else {})."""
        if hasattr(self, "moe"):
            return moe.moe_apply(self.moe, y, moe_spec(self.cfg))
        return layers.mlp_apply(self.mlp, y, self.cfg.act), {}

    def forward(self, x: torch.Tensor, positions: torch.Tensor, *,
                capture: bool = False, impl: str | None = None):
        """(x, cache entry, aux).  The entry, when ``capture``, holds the
        layer's serving state: k, v (local: the last ``window``
        positions); rwkv's state and token-shift carries; rglru's last h
        and conv window.  Else it is empty."""
        cfg = self.cfg
        entry: dict[str, torch.Tensor] = {}
        aux: dict[str, torch.Tensor] = {}
        h = layers.norm_apply(self.norm1, x, cfg.norm)
        if self.kind in ATTN_KINDS:
            q, k, v = layers.qkv(self.attn, self.spec, h, positions)
            o = layers.blockwise_attention(q, k, v, spec=self.spec,
                                           q_offset=0, impl=impl)
            # pinned batch-only: the backward's gradient of the heads'
            # view then arrives whole, where DTensor cannot view a
            # TP-split row as heads that do not divide the mesh axis
            x = x + (shard_batch(o.reshape(*o.shape[:2], -1))
                     @ self.attn["wo"])
            if capture:
                if self.kind == "local":
                    w = min(cfg.window, k.shape[1])
                    entry = {"k": k[:, -w:], "v": v[:, -w:]}
                else:
                    entry = {"k": shard_kv_capture(k),
                             "v": shard_kv_capture(v)}
        elif self.kind == "rwkv":
            if capture:
                o, state, x_last = rwkv6.time_mix(self.tm, self.spec, h,
                                                  return_state=True)
            else:
                o = rwkv6.time_mix(self.tm, self.spec, h)
            x = x + o
            y = layers.norm_apply(self.norm2, x, cfg.norm)
            if capture:
                entry = {"state": state, "tm_prev": x_last,
                         "cm_prev": y[:, -1]}
            return x + rwkv6.channel_mix(self.tm, self.spec, y), entry, aux
        else:
            if capture:
                o, h_last, conv = rglru.rglru_apply(self.rec, self.spec, h,
                                                    return_state=True)
                entry = {"h": h_last, "conv": conv}
            else:
                o = rglru.rglru_apply(self.rec, self.spec, h)
            x = x + o
        y = layers.norm_apply(self.norm2, x, cfg.norm)
        f, aux = self.ffn(y)
        return x + f, entry, aux


def _mean_aux(cfg: ModelConfig, per_layer: list[dict]) -> dict:
    """The JAX package's aux reduction: for each pattern position the mean
    over the scanned cycles, then one entry for each tail layer, then the
    mean of that list."""
    pat = len(cfg.block_pattern)
    nc, _ = n_cycles(cfg)
    auxes = []
    for j in range(pat if nc else 0):
        group = per_layer[j:nc * pat:pat]
        if group[0]:
            auxes.append({k: torch.stack([a[k] for a in group]).mean()
                          for k in group[0]})
    auxes += [a for a in per_layer[nc * pat:] if a]
    if not auxes:
        return {}
    return {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}


def _vocab_split(w: torch.Tensor) -> torch.Tensor:
    """An embedding table for a lookup: a DTensor keeps only its vocab
    split, its D axis gathered first (the ZeRO-3 gather every parameter
    takes): DTensor's lookup in a table sharded on both axes masks the
    vocab with the wrong shard's indices.  Any other tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate, Shard
    return w.redistribute(w.device_mesh, [
        p if p == Shard(0) else Replicate() for p in w.placements])


class Transformer(nn.Module):
    """Embedding, ``cfg.n_layers`` decoder layers, final norm, unembedding.

    Every parameter is trainable; the serving entry points (``forward``,
    ``model.prefill``, ``kvcache.decode_step``) run without autograd.
    """

    def __init__(self, cfg: ModelConfig, p: Mapping[str, Any]):
        super().__init__()
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

    def embed_tokens(self, tokens: torch.Tensor,
                     frontend_embeds: torch.Tensor | None = None
                     ) -> torch.Tensor:
        """Token embeddings (plus sinusoidal positions), the frontend's
        embeddings in the first ``cfg.frontend_tokens`` positions when
        given (ignored for a config without frontend tokens)."""
        # F.embedding: its backward adds the rows' gradients without
        # atomics (an index's adds in a fixed order), so steps repeat bitwise
        x = shard_batch(F.embedding(tokens.long(), _vocab_split(self.embed)))
        if self.cfg.pos == "sinusoidal":
            pos = torch.arange(tokens.shape[1], device=tokens.device)
            x = x + layers.sinusoidal(pos, self.cfg.d_model)[None].to(x.dtype)
        n = self.cfg.frontend_tokens
        if frontend_embeds is not None and n:
            if tokens.shape[1] < n:
                raise ValueError(f"{self.cfg.name}: {tokens.shape[1]} tokens "
                                 f"cannot hold the {n} frontend positions")
            x = torch.cat([frontend_embeds[:, :n].to(x.dtype), x[:, n:]], 1)
        return x

    @torch.no_grad()
    def forward(self, tokens: torch.Tensor,
                frontend_embeds: torch.Tensor | None = None, *,
                capture_cache: bool = False, impl: str | None = None):
        """Full-sequence forward of ``tokens`` (B, S).  Returns (hidden
        after the final norm, per-layer cache entries in layer order, empty
        unless ``capture_cache``)."""
        x = self.embed_tokens(tokens, frontend_embeds)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        entries = []
        pat = len(self.cfg.block_pattern)
        nc, _ = n_cycles(self.cfg)
        for i, layer in enumerate(self.layers):
            if i < nc * pat and i % pat == 0:
                x = shard_batch(x)          # re-anchor DP at each cycle
            x, e, _ = layer(x, positions, capture=capture_cache, impl=impl)
            if i < nc * pat and i % pat == pat - 1:
                x = shard_batch(x)
            if capture_cache:
                entries.append(e)
        x = layers.norm_apply(self.final_norm, x, self.cfg.norm)
        return x, entries

    def _cycle(self, x: torch.Tensor, positions: torch.Tensor, first: int,
               impl: str | None) -> tuple[torch.Tensor, list[dict]]:
        auxes = []
        x = shard_batch(x)                  # re-anchor DP at each cycle
        for layer in self.layers[first:first + len(self.cfg.block_pattern)]:
            x, _, a = layer(x, positions, impl=impl)
            auxes.append(a)
        return shard_batch(x), auxes

    def forward_train(self, tokens: torch.Tensor,
                      frontend_embeds: torch.Tensor | None = None, *,
                      remat: bool = True, impl: str | None = None
                      ) -> tuple[torch.Tensor, dict]:
        """Full-sequence forward of ``tokens`` (B, S) for the loss: the
        hidden state after the final norm, recorded by autograd, and the
        aux (the MoE's ``moe_aux`` and ``moe_dropped``, reduced as the JAX
        package reduces them; else {}).

        ``remat`` is the JAX ``remat``: each of the ``n_cycles`` whole
        cycles is one ``torch.utils.checkpoint`` (non-reentrant), so the
        backward recomputes it from its input, the MoE's routing included
        (the same input routes the same way), and keeps none of its
        activations; the tail layers keep theirs.  The attention forward
        then runs twice for every layer of a cycle and once for a tail
        layer.
        """
        x = self.embed_tokens(tokens, frontend_embeds)
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        pat = len(self.cfg.block_pattern)
        nc, _ = n_cycles(self.cfg)
        per_layer: list[dict] = []
        for c in range(nc):
            if remat:
                x, auxes = checkpoint(self._cycle, x, positions, c * pat,
                                      impl, use_reentrant=False)
            else:
                x, auxes = self._cycle(x, positions, c * pat, impl)
            per_layer += auxes
        for layer in self.layers[nc * pat:]:
            x, _, a = layer(x, positions, impl=impl)
            per_layer.append(a)
        x = layers.norm_apply(self.final_norm, x, self.cfg.norm)
        return x, _mean_aux(self.cfg, per_layer)

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
    lp = {"norm1": layers.norm_init(cfg.d_model, cfg.norm, dt, gen.device),
          "norm2": layers.norm_init(cfg.d_model, cfg.norm, dt, gen.device)}
    if kind in ATTN_KINDS:
        lp["attn"] = layers.attn_init(gen, attn_spec(cfg, kind))
    elif kind == "rwkv":
        lp["tm"] = rwkv6.rwkv_init(gen, rwkv_spec(cfg))
    elif kind == "rglru":
        lp["rec"] = rglru.rglru_init(gen, rglru_spec(cfg))
    else:
        raise ValueError(f"unknown block kind {kind!r}; expected one of "
                         f"{BLOCK_KINDS}")
    if kind != "rwkv":                        # rwkv carries its channel mix
        if cfg.is_moe:
            lp["moe"] = moe.moe_init(gen, moe_spec(cfg))
        else:
            lp["mlp"] = layers.mlp_init(gen, cfg.d_model, cfg.d_ff, dt)
    return lp


def init(gen: torch.Generator, cfg: ModelConfig) -> Transformer:
    """Random weights on the generator's device, drawn in this order: the
    embedding, the unembedding, then per layer the block's weights (wq,
    wk, wv, wo; or ``rwkv6.rwkv_init``'s; or ``rglru.rglru_init``'s) and
    the feed-forward's (w_gate, w_up, w_down; or ``moe.moe_init``'s).  The
    leaves the JAX init keeps in f32 are f32 here too.  The stream is not
    ``jax.random``'s: weights that must equal the JAX model's come through
    :func:`params_from_jax`."""
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


class _MetaGenerator(torch.Generator):
    """A generator whose draws are meta tensors: ``torch.randn(...,
    generator=g, device=g.device)`` gives the shape and dtype and draws
    nothing (``torch.Generator`` has no meta device)."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def init_meta(cfg: ModelConfig) -> Transformer:
    """The stack of :func:`init` as meta tensors: every leaf's shape and
    dtype (the f32 leaves f32), nothing drawn or allocated; the counterpart
    of the JAX ``jax.eval_shape(model.init, key)``.  Seconds even for
    llama4_scout's 107.77B parameters."""
    return init(_MetaGenerator(), cfg)


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig,
                    device=None) -> Transformer:
    """The port's stack holding the weights of a JAX param tree.

    ``tree`` is ``repro.models.transformer.init``'s tree with numpy leaves
    (bf16 leaves may be ml_dtypes arrays): ``embed``, ``final_norm``,
    ``lm_head`` (untied), ``scan`` (a tuple over pattern positions, each
    leaf with a leading ``n_cycles`` axis) and ``tail``.  Layer
    ``c * P + j`` takes ``scan[j][c]``, then come the tail's layers.  A
    float32 leaf stays float32; every other leaf takes ``cfg.dtype``.
    ``device=None`` means the card.
    """
    dev = resolve_device(device)
    dt = layers.torch_dtype(cfg.dtype)

    def conv(a):
        a = np.asarray(a)
        to = torch.float32 if a.dtype == np.float32 else dt
        return torch.from_numpy(np.array(a, np.float32)).to(dev, to)

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
