"""AlexNet — the paper's own Table-1 architecture (hybrid DP/TP CNN).

A copy of the reference's ``configs/alexnet.py``: data-parallel conv
features + model-parallel FC classifier (ref [8], "one weird trick"),
which is exactly dMath's hybrid scheme.  The network is
:mod:`repro_torch.models.convnet`; as in the reference, ``ARCH_IDS`` does
not list it, so no dry-run cell plans it.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="alexnet", family="conv",
    n_layers=8, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=4096, vocab_size=1000,       # 1000 ImageNet classes
    source="NIPS 2012 [5]; paper Table 1",
))
