"""zamba2-1.2b — Mamba2 backbone + shared attention block
[arXiv:2411.15242; hf].

The shared transformer block (attention + MLP, one set of weights) is
applied every 6 mamba layers — dMath-style weight reuse (§3.3 caching).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    attn_every=6,
    source="arXiv:2411.15242; hf",
))
