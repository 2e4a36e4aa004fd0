"""rwkv6-3b "Finch" [arXiv:2404.05892] — attention-free SSM."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6_3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65536,
    block_pattern=("rwkv",), pos="none",
    supports_long_context=True,
    notes="data-dependent decay; O(1) state => runs long_500k.",
)
