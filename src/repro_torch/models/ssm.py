"""The Mamba2 (SSD) mixer, ported from the reference's ``models/ssm.py``
for one device: the full-sequence ``forward`` (prefill) and the
single-token ``decode_step``.

``forward`` runs the chunked scan through :func:`repro_torch.kernels.ops.ssd`
(the CUDA kernel on the card), where the reference model runs its jnp
``ssd_chunked``; ``decode_step`` runs :func:`repro_torch.kernels.ops.ssd_step`,
plain PyTorch on every device, as in the reference.  Every product goes
through :func:`repro_torch.core.precision.einsum` (the GEMM kernel on the
card) and returns fp32, so the convolutions, the scan and the gated norm
run on fp32 activations, as the reference's do.  The sequence-parallel
``forward_shardmap`` comes with the distributed slices.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import precision
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec


def ssm_specs(cfg) -> Dict[str, ParamSpec]:
    D, di = cfg.d_model, cfg.d_inner
    H, G, N, W = cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.conv_width
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    return {
        "wx": ParamSpec((D, di)),
        "wz": ParamSpec((D, di)),
        "wbc": ParamSpec((D, 2 * G * N)),
        "wdt": ParamSpec((D, H)),
        "dt_bias": ParamSpec((H,), dtype=torch.float32, init="dt_bias"),
        "A": ParamSpec((H,), dtype=torch.float32, init="ssm_a"),
        "D_skip": ParamSpec((H,), dtype=torch.float32, init="ones"),
        "conv_x": ParamSpec((W, di), scale=0.5 / W),
        "conv_bc": ParamSpec((W, 2 * G * N), scale=0.5 / W),
        "gate_norm": ParamSpec((di,), init="ones"),
        "w_out": ParamSpec((di, D), init="scaled", scale=out_scale),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S.  u: (B, S, C), w: (W, C).

    Returns (out, new_state), the state being the last W-1 inputs."""
    Wd = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], Wd - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    ext = torch.cat([pad, u], dim=1)                          # (B, S+W-1, C)
    out = sum(ext[:, i:i + u.shape[1], :] * w[i][None, None, :]
              for i in range(Wd))
    new_state = ext[:, ext.shape[1] - (Wd - 1):, :] if Wd > 1 else None
    return out.to(u.dtype), new_state


def _project(x, p, policy):
    """The four input products and dt = softplus(x wdt + dt_bias)."""
    xz = precision.einsum("bsd,de->bse", x, p["wx"], policy=policy)
    z = precision.einsum("bsd,de->bse", x, p["wz"], policy=policy)
    bc = precision.einsum("bsd,de->bse", x, p["wbc"], policy=policy)
    dt_raw = precision.einsum("bsd,dh->bsh", x, p["wdt"], policy=policy)
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    return xz, z, bc, dt


def _gated_out(y, xh, z, p, cfg, policy):
    """D skip, gated RMSNorm ``norm(y * silu(z))`` and the out product."""
    y = y + xh * p["D_skip"].float()[:, None].to(y.dtype)
    y = y.reshape(*z.shape)
    y = layers.rms_norm(y * F.silu(z.float()).to(y.dtype), p["gate_norm"],
                        cfg.norm_eps)
    return precision.einsum("bse,ed->bsd", y, p["w_out"], policy=policy)


def forward(
    x: torch.Tensor,              # (B, S, D)
    p: dict,
    cfg,
    *,
    policy=precision.MIXED,
    ssd_chunk: int = 256,
    conv_state: Optional[torch.Tensor] = None,
    ssm_state: Optional[torch.Tensor] = None,
    with_state: bool = False,
):
    """Full-sequence Mamba2 mixer.  Returns (y in x's dtype,
    (conv_state, ssd_state, bc_conv_state) or None)."""
    B, S, _ = x.shape
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state

    xz, z, bc, dt = _project(x, p, policy)
    xz, conv_new = _causal_conv(xz, p["conv_x"].to(xz.dtype), conv_state)
    xz = F.silu(xz)
    bc, bc_conv_new = _causal_conv(bc, p["conv_bc"].to(bc.dtype), None)
    bc = F.silu(bc)

    xh = xz.reshape(B, S, H, P)
    Bm = bc[..., :G * N].reshape(B, S, G, N).contiguous()
    Cm = bc[..., G * N:].reshape(B, S, G, N).contiguous()
    y, state = ops.ssd(xh, dt.contiguous(), p["A"], Bm, Cm, chunk=ssd_chunk,
                       init_state=ssm_state)
    out = _gated_out(y, xh, z, p, cfg, policy)
    return out.to(x.dtype), ((conv_new, state, bc_conv_new) if with_state
                             else None)


def decode_step(
    x: torch.Tensor,              # (B, 1, D)
    p: dict,
    cfg,
    conv_state: torch.Tensor,     # (B, W-1, d_inner)
    ssm_state: torch.Tensor,      # (B, H, P, N)
    bc_conv_state: torch.Tensor,  # (B, W-1, 2GN)
    *,
    policy=precision.MIXED,
):
    """Single-token SSD recurrence step.  Returns (y, conv_state,
    ssm_state, bc_conv_state), the states as new tensors."""
    B = x.shape[0]
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    G, N = cfg.ssm_groups, cfg.ssm_state

    xz, z, bc, dt = _project(x, p, policy)
    dt = dt[:, 0]                                             # (B, H)
    xz1, conv_state = _causal_conv(xz, p["conv_x"].to(xz.dtype), conv_state)
    bc1, bc_conv_state = _causal_conv(bc, p["conv_bc"].to(bc.dtype),
                                      bc_conv_state)
    xz1 = F.silu(xz1)
    bc1 = F.silu(bc1)
    xh = xz1.reshape(B, H, P)
    Bm = bc1[:, 0, :G * N].reshape(B, G, N)
    Cm = bc1[:, 0, G * N:].reshape(B, G, N)

    y, ssm_state = ops.ssd_step(xh, dt, p["A"].float(), Bm, Cm, ssm_state)
    out = _gated_out(y, xh, z, p, cfg, policy)
    return out.to(x.dtype), conv_state, ssm_state, bc_conv_state
