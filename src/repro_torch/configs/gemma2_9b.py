"""gemma2-9b [arXiv:2408.00118] — alternating local/global, logit softcaps."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2_9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab_size=256000,
    block_pattern=("local", "global"), window=4096,
    logit_softcap=30.0, attn_softcap=50.0,
    supports_long_context=True,
    notes="1:1 local:global; long_500k borderline (21 global layers hold "
          "full KV, seq-sharded) — see roofline table.",
)
