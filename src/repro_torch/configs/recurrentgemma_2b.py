"""recurrentgemma-2b [arXiv:2402.19427] — RG-LRU + local attention, 1:2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma_2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"), window=2048,
    lru_width=2560,
    supports_long_context=True,
    notes="2 RG-LRU : 1 local-attn; O(1)/windowed state => runs long_500k.",
)
