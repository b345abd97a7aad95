"""mamba2-780m — attention-free SSD [arXiv:2405.21060; unverified].

vocab 50280 is padded to 50304 (multiple of 128) for model-axis TP — the
classic Megatron-style vocab pad; logits over pad ids are masked to -inf.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    source="arXiv:2405.21060; unverified",
))
