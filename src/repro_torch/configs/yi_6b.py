"""yi-6b [arXiv:2403.04652] — llama-architecture GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi_6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64000,
    block_pattern=("global",),
    notes="pure full attention => long_500k skipped.",
)
