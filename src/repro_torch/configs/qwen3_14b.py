"""qwen3-14b — dense, GQA kv=8, qk_norm [hf:Qwen/Qwen3-8B; hf]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B; hf",
))
