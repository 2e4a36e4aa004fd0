"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

Text backbone only ("early fusion" multimodality is out of the assigned
scope — no frontend listed).  MoE 16 routed experts top-1 plus one shared
expert per layer (Llama-4 uses a shared expert alongside the routed one).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4_scout", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048,
    n_experts=16, experts_per_token=1, n_shared_experts=1,
    block_pattern=("global",),
    notes="MoE 16e top-1 + shared expert; chunked-attention long context "
          "not modelled => long_500k skipped (quadratic global attention).",
)
