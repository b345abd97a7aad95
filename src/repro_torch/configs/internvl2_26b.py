"""internvl2-26b — InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

Backbone only: the InternViT patch embedder is a stub; input_specs()
provides 1024 precomputed patch embeddings per sample, prepended to the
text sequence. vocab 92553 padded to 92672.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    n_vision_tokens=1024, frontend="vit",
    source="arXiv:2404.16821; hf",
))
