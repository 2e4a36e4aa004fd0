"""llava-next-34b [hf:llava-hf/llava-v1.6; unverified] — VLM.

Backbone per the assignment (Yi-34B-like dense GQA).  The anyres vision
tower is a STUB: input_specs() provides precomputed patch embeddings that
early-fuse into the first `frontend_tokens` positions.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava_next_34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    block_pattern=("global",),
    frontend="vision", frontend_tokens=1152,
    notes="anyres tiling stub: 1152 patch embeddings (2x 24x24 tiles).",
)
