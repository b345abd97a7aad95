"""The Mamba2 (SSD) mixer, ported from the reference's ``models/ssm.py``:
the full-sequence ``forward`` (prefill and the one-rank train path), its
counterpart on a ``(data, model)`` mesh (``forward_mesh``) and the
single-token ``decode_step``.

``forward`` runs the chunked scan through :func:`repro_torch.kernels.ops.ssd`
(the CUDA kernels on the card, forward and backward), where the reference
model runs its jnp ``ssd_chunked``; ``decode_step`` runs
:func:`repro_torch.kernels.ops.ssd_step`, plain PyTorch on every device,
as in the reference.  Every product goes through
:func:`repro_torch.core.precision.einsum` (the GEMM kernel on the card)
and returns fp32, so the convolutions, the scan and the gated norm run on
fp32 activations, as the reference's ``forward`` does.

``forward_mesh`` runs this rank's heads (``H / model``) on its blocks of
the params in the planner's layouts (:func:`ssm_specs`): under the
sequence-parallel residual the reference's ``forward_shardmap`` (one bf16
all-gather of the residual, bf16 convolutions and scan inputs, one fp32
sum of squares over the model axis for the gated norm, the bf16
reduce-scatter of the output), else its head-TP ``forward`` on the
replicated residual (fp32 convolutions, the output's shares summed in
fp32).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import distributed as dist_mod
from repro_torch.core import precision
from repro_torch.core.layout import Layout
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.models.params import ParamSpec, plan_layout


def ssm_specs(cfg, plan=None, mesh=None) -> Dict[str, ParamSpec]:
    """The mixer's leaves; given a plan and a mesh, with the plan's
    layouts (the reference's ``ssm_specs``)."""
    D, di = cfg.d_model, cfg.d_inner
    H, G, N, W = cfg.n_ssm_heads, cfg.ssm_groups, cfg.ssm_state, cfg.conv_width
    out_scale = 0.02 / max(1, 2 * cfg.n_layers) ** 0.5
    lay = functools.partial(plan_layout, plan, mesh)
    whole = (lambda n: None) if plan is None else Layout.replicated
    return {
        "wx": ParamSpec((D, di), layout=lay("ffn_in", (D, di))),
        "wz": ParamSpec((D, di), layout=lay("ffn_in", (D, di))),
        "wbc": ParamSpec((D, 2 * G * N),
                         layout=lay("router", (D, 2 * G * N))),
        "wdt": ParamSpec((D, H), layout=lay("router", (D, H))),
        "dt_bias": ParamSpec((H,), dtype=torch.float32, init="dt_bias",
                             layout=lay("head_vector", (H,))),
        "A": ParamSpec((H,), dtype=torch.float32, init="ssm_a",
                       layout=lay("head_vector", (H,))),
        "D_skip": ParamSpec((H,), dtype=torch.float32, init="ones",
                            layout=lay("head_vector", (H,))),
        "conv_x": ParamSpec((W, di), scale=0.5 / W,
                            layout=lay("conv1d", (W, di))),
        "conv_bc": ParamSpec((W, 2 * G * N), scale=0.5 / W,
                             layout=whole(2)),
        "gate_norm": ParamSpec((di,), init="ones", layout=whole(1)),
        "w_out": ParamSpec((di, D), init="scaled", scale=out_scale,
                           layout=lay("ffn_out", (di, D))),
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


def forward_mesh(x: torch.Tensor, p: dict, cfg, plan, mesh, *,
                 policy=precision.MIXED) -> torch.Tensor:
    """The mixer on this rank's block ``x`` of the residual (the plan's
    hidden layout) and its blocks ``p`` of the params at their use
    layouts: the columns of this rank's heads of ``wx``, ``wz``,
    ``conv_x`` and ``w_out``'s rows (taken here where the plan keeps
    ``wx``, ``wz`` and ``w_out`` whole, ``ffn_replicated``), its heads'
    ``dt_bias``, ``A`` and ``D_skip``, and the whole of ``wbc``, ``wdt``,
    ``conv_bc`` and ``gate_norm``, of which it takes its heads' columns.
    Returns the output in ``x``'s layout and dtype.

    Where the line shares a value that enters work split over it, the
    split's entry sums the ranks' shares in the backward (``copy_ad``:
    the replicated residual; the norm's sum of squares, whose psum every
    rank then uses on its own columns)."""
    tp = plan.tp_axis
    n, r = mesh.shape[tp], mesh.coords[tp]
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    G, N, di = cfg.ssm_groups, cfg.ssm_state, cfg.d_inner
    h_loc = H // n                 # the model refuses H % n on a mesh
    cols = slice(r * h_loc * P, (r + 1) * h_loc * P)
    if plan.ffn_replicated:
        # the plan stores the d_inner products whole (the hybrid's SP
        # attention keeps its FFNs replicated): this rank's heads' blocks
        p = dict(p, wx=p["wx"][:, cols], wz=p["wz"][:, cols],
                 w_out=p["w_out"][cols])
    sp = plan.seq_parallel_residual
    # SP: the bf16 wire and bf16 convolutions of forward_shardmap
    xg = (dist_mod.all_gather_ad(x, mesh, tp, 1) if sp
          else dist_mod.copy_ad(x, mesh, tp))
    xz, z, bc, dt = _project(
        xg, dict(p, wdt=p["wdt"][:, r * h_loc:(r + 1) * h_loc]), policy)
    act = xg.dtype if sp else xz.dtype
    xz, _ = _causal_conv(xz.to(act), p["conv_x"].to(act))
    xz = F.silu(xz)
    bc, _ = _causal_conv(bc.to(act), p["conv_bc"].to(act))
    bc = F.silu(bc)
    b, s = xg.shape[0], xg.shape[1]
    xh = xz.reshape(b, s, h_loc, P)
    Bm = bc[..., :G * N].reshape(b, s, G, N).contiguous()
    Cm = bc[..., G * N:].reshape(b, s, G, N).contiguous()
    y, _ = ops.ssd(xh, dt.contiguous(), p["A"].float(), Bm, Cm)
    y = y + xh * p["D_skip"].float()[:, None].to(y.dtype)
    y = y.reshape(b, s, h_loc * P)
    # the gated RMSNorm over the whole d_inner: one fp32 sum of squares
    v = (y * F.silu(z.float()).to(y.dtype)).float()
    ss = dist_mod.psum_ad(torch.sum(v * v, -1, keepdim=True), mesh, tp)
    ss = precision.div_count(dist_mod.copy_ad(ss, mesh, tp), di)
    v = (v * torch.rsqrt(ss + cfg.norm_eps)
         * p["gate_norm"][cols].float()).to(y.dtype)
    out = precision.einsum("bse,ed->bsd", v, p["w_out"], policy=policy)
    if sp:
        return dist_mod.psum_scatter_ad(out.to(x.dtype), mesh, tp, 1)
    return dist_mod.psum_ad(out, mesh, tp).to(x.dtype)


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
