"""Model/shape config schema + registry (``--arch <id>`` selection).

A copy of the JAX reference's ``configs/base.py``; the port keeps its own
copy so it never imports the reference.  ``cells`` is the reference's:
over :data:`ARCH_IDS`, which lists no alexnet in either package (its
config is ``configs/alexnet.py``, its network ``models/convnet.py``).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
from typing import Dict, Optional, Tuple

_REGISTRY: Dict[str, "ModelConfig"] = {}

ARCH_IDS = [
    "qwen2-0.5b", "gemma-2b", "gemma3-27b", "qwen3-14b", "dbrx-132b",
    "deepseek-moe-16b", "mamba2-780m", "zamba2-1.2b", "musicgen-medium",
    "internvl2-26b",
]


def _pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One assigned architecture, exactly as specified in the brief."""

    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention variants
    qkv_bias: bool = False          # qwen2
    qk_norm: bool = False           # qwen3
    attn_softcap: Optional[float] = None
    rope_theta: float = 1e4
    window: Optional[int] = None    # sliding-window size for local layers
    local_global_pattern: int = 0   # N local per 1 global (gemma3: 5)
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU)
    emb_scale: bool = False         # gemma multiplies embeddings by sqrt(D)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    conv_width: int = 4

    # hybrid (zamba2): shared attention block every N mamba layers
    attn_every: int = 0

    # multimodal stub frontends
    n_vision_tokens: int = 0        # internvl: patch embeddings per sample
    frontend: str = "none"          # none | encodec | vit

    norm_eps: float = 1e-6
    source: str = ""                # provenance note from the brief

    # -- derived -------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        # multiple of 128 (MXU lanes) which also covers model-axis 16
        return _pad_to(self.vocab_size, 128)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def d_head(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_shared_ff(self) -> int:
        return self.n_shared_experts * self.d_ff_expert

    def has_attention(self) -> bool:
        return self.family != "ssm"

    def is_global_layer(self, i: int) -> bool:
        """gemma3 5:1 pattern — every (N+1)-th layer is global."""
        if not self.local_global_pattern:
            return True
        return (i + 1) % (self.local_global_pattern + 1) == 0

    def supports_long_context(self) -> bool:
        """long_500k runs only for sub-quadratic families (brief)."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (drives FSDP decisions + MODEL_FLOPS)."""
        D, V = self.d_model, self.padded_vocab
        total = 2 * V * D                            # embed + unembed
        per_layer = 0
        if self.family in ("dense", "moe", "audio", "vlm", "hybrid"):
            hd = self.d_head
            attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
                + self.n_heads * hd * D
            if self.family == "hybrid":
                # shared attention + MLP block counted once
                n_attn_layers = 1
                per_layer_attn = 0
                total += attn + 3 * D * self.d_ff
            else:
                per_layer_attn = attn
            if self.family == "moe":
                ffn = self.n_experts * 3 * D * self.d_ff_expert \
                    + D * self.n_experts \
                    + 3 * D * self.d_shared_ff
            elif self.family == "hybrid":
                ffn = 0
            else:
                ffn = 3 * D * self.d_ff
            per_layer += per_layer_attn + ffn + 2 * D
        if self.family in ("ssm", "hybrid"):
            di, N, G, H = self.d_inner, self.ssm_state, self.ssm_groups, \
                self.n_ssm_heads
            ssm = 2 * D * di + D * 2 * G * N + D * H + 3 * H \
                + self.conv_width * (di + 2 * G * N) + di + di * D + D
            per_layer += ssm
        total += self.n_layers * per_layer + D      # final norm
        return total

    def active_param_count(self) -> int:
        """Active (per-token) params: MoE counts top_k + shared experts."""
        if self.family != "moe":
            return self.param_count()
        D = self.d_model
        dense_like = self.param_count() - self.n_layers * (
            self.n_experts - self.top_k) * 3 * D * self.d_ff_expert
        return dense_like


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell from the brief."""

    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "long_decode"),
}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        # lazy-import the arch module (configs/<id with - as _>.py)
        mod = name.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")
    return _REGISTRY[name]


def all_archs() -> Tuple[str, ...]:
    return tuple(ARCH_IDS)


def cells(include_skipped: bool = False):
    """All (arch, shape) cells of the architectures whose config module
    the port has; long_500k only for sub-quadratic families."""
    out = []
    for a in ARCH_IDS:
        mod = a.replace("-", "_").replace(".", "_")
        if importlib.util.find_spec(f"repro_torch.configs.{mod}") is None:
            continue
        cfg = get_config(a)
        for s in SHAPES.values():
            if s.kind == "long_decode" and not cfg.supports_long_context():
                if include_skipped:
                    out.append((a, s.name, "SKIP: quadratic attention at 500k"))
                continue
            out.append((a, s.name, None) if include_skipped else (a, s.name))
    return out


def scale_config(cfg: ModelConfig, down: int) -> ModelConfig:
    """Reduced-config variant of an arch (same family/topology).

    Divides every capacity dim by ``down`` with per-field floors so the
    result stays a valid member of the family — the knob the CPU-container
    launchers and examples use (``--scale-down``).  Lives here (not in
    ``launch/``) because the reference's ``Session.plan`` applies it too.
    """
    if down <= 1:
        return cfg
    r = lambda x, m=8: max(m, x // down)
    kw = dict(
        n_layers=max(2, cfg.n_layers // down),
        d_model=r(cfg.d_model, 64),
        d_ff=r(cfg.d_ff, 64) if cfg.d_ff else 0,
        vocab_size=max(256, cfg.vocab_size // down),
    )
    if cfg.n_heads:
        heads = max(2, cfg.n_heads // down)
        kv = max(1, min(cfg.n_kv_heads, heads))
        kw.update(n_heads=heads, n_kv_heads=kv,
                  head_dim=max(8, kw["d_model"] // heads))
    if cfg.n_experts:
        kw.update(n_experts=max(4, cfg.n_experts // down),
                  top_k=min(cfg.top_k, 2),
                  d_ff_expert=r(cfg.d_ff_expert, 32))
    if cfg.ssm_state:
        kw.update(ssm_state=max(16, cfg.ssm_state // down),
                  ssm_head_dim=16)
    if cfg.attn_every:
        kw.update(attn_every=2)
    if cfg.n_vision_tokens:
        kw.update(n_vision_tokens=16)
    if cfg.window:
        kw.update(window=16)
    return dataclasses.replace(cfg, **kw)
