"""Config system of the port: model architecture + input-shape registry
(``--arch <id>``).

``ModelConfig``, ``ShapeSpec``, ``SHAPES`` and ``reduced()`` are verbatim
copies of ``repro.configs.base``.  Only the architectures whose every block
kind is ported have a config here (:data:`ARCH_IDS`, the LMs, and
``yadt``, the tree workload); any other name raises, naming the ROADMAP
item that ports it.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Iterable

#: Architectures of the JAX package (``repro.configs.base.ARCH_IDS``).
JAX_ARCH_IDS = (
    "phi35_moe", "llama4_scout", "llava_next_34b", "rwkv6_3b", "phi4_mini",
    "gemma3_4b", "gemma2_9b", "yi_6b", "musicgen_medium", "recurrentgemma_2b",
    "yadt",
)
#: The ported LMs: global/local attention with a dense MLP.
ARCH_IDS = ("gemma2_9b", "yi_6b", "gemma3_4b", "phi4_mini")
#: The ported tree workload (``configs/yadt.py``), no LM.
TREE_ARCH_IDS = ("yadt",)
NOT_PORTED = ("ROADMAP.md, the other architectures and block kinds (MoE, "
              "RWKV, RG-LRU, frontends: llama4_scout, llava_next_34b, "
              "musicgen_medium, phi35_moe, recurrentgemma_2b, rwkv6_3b)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio|tree
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple[str, ...] = ("global",)  # cycled: global|local|rwkv|rglru
    window: int = 4096
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    logit_softcap: float = 0.0
    attn_softcap: float = 0.0
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"
    act: str = "silu"
    pos: str = "rope"                 # rope|sinusoidal|none
    tie_embeddings: bool = False
    frontend: str | None = None       # None|vision|audio
    frontend_tokens: int = 0
    lru_width: int = 0
    conv_width: int = 4
    supports_long_context: bool = False
    dtype: str = "bfloat16"
    notes: str = ""

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + per-layer blocks)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        for i in range(self.n_layers):
            kind = self.block_kind(i)
            if kind in ("global", "local"):
                total += d * self.head_dim * (self.n_heads * 2
                                              + self.n_kv_heads * 2)
            elif kind == "rwkv":
                total += 5 * d * d + 2 * 64 * d      # time-mix + decay lora
            elif kind == "rglru":
                w = self.lru_width or d
                total += 3 * d * w + 2 * w * w + self.conv_width * w
            if kind == "rwkv":
                total += 2 * d * f + d * d           # channel-mix
            elif self.is_moe:
                total += self.n_experts * 3 * d * f \
                    + self.n_shared_experts * 3 * d * f + d * self.n_experts
            else:
                total += 3 * d * f
            total += 2 * d                           # norms
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        inactive = (self.n_experts - self.experts_per_token) * 3 * d * f
        return self.param_count() - self.n_layers * inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCH_IDS + TREE_ARCH_IDS:
        known = "an architecture of the JAX package" if arch in JAX_ARCH_IDS \
            else "not an architecture of the repo"
        raise ValueError(f"--arch {arch!r} is not ported ({known}); ported: "
                         f"{', '.join(ARCH_IDS + TREE_ARCH_IDS)}; see "
                         f"{NOT_PORTED}")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def registry() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def runnable_shapes(cfg: ModelConfig) -> Iterable[ShapeSpec]:
    for shape in SHAPES.values():
        if shape.name == "long_500k" and not cfg.supports_long_context:
            continue   # quadratic-attention arch: skip per brief, see DESIGN.md
        yield shape


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    base = dict(
        n_layers=min(cfg.n_layers, 2 * max(1, len(cfg.block_pattern))),
        d_model=128,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        n_experts=min(cfg.n_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        lru_width=128 if cfg.lru_width else 0,
        frontend_tokens=min(cfg.frontend_tokens, 8),
        window=min(cfg.window, 64) if cfg.window else 0,
    )
    if cfg.family == "audio":
        base["n_kv_heads"] = base["n_heads"]      # musicgen is MHA
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
