"""phi4-mini-3.8b [arXiv:2412.08905] — dense RoPE SwiGLU GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi4_mini", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=200064,
    block_pattern=("global",),
    notes="pure full attention => long_500k skipped.",
)
