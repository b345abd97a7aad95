"""musicgen-medium — decoder-only over EnCodec tokens
[arXiv:2306.05284; hf].

Backbone only: the EnCodec frontend is a stub; input_specs() provides the
discrete codes directly (vocab 2048). MHA (kv == q heads).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    frontend="encodec",
    source="arXiv:2306.05284; hf",
))
