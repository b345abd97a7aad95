"""gemma3-27b — dense, GQA kv=16, 5:1 local:global, 128k ctx
[hf:google/gemma-3-1b-pt; unverified]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-27b", family="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=21504, vocab_size=262144,
    act="gelu", emb_scale=True, qk_norm=True,
    window=1024, local_global_pattern=5, rope_theta=1e6,
    source="hf:google/gemma-3-1b-pt; unverified",
))
