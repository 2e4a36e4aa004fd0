"""musicgen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

The EnCodec tokenizer/vocoder is a STUB: input_specs() provides the token
stream (train) or precomputed frame embeddings (frontend early-fusion).
MHA (kv == heads == 24), sinusoidal positions, layernorm.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen_medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    block_pattern=("global",), norm="layernorm", act="gelu",
    pos="sinusoidal",
    frontend="audio", frontend_tokens=0,
    notes="full attention => long_500k skipped.",
)
