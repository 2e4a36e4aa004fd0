"""gemma3-4b [hf:google/gemma-3; unverified] — 5:1 local:global, 128k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3_4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144,
    block_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    supports_long_context=True,
    notes="5:1 local:global; long_500k runs with window-bounded local KV "
          "and seq-sharded global KV (1 in 6 layers).",
)
