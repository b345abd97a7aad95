"""qwen2-0.5b — dense, GQA kv=2, QKV bias [arXiv:2407.10671; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936,
    qkv_bias=True, rope_theta=1e6,
    source="arXiv:2407.10671; hf",
))
