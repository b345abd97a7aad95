"""AdamW with fp32 master weights and fp32 moments, ported from the
reference's ``train/optimizer.py`` (implemented from scratch there too).

State = ``{step, mu, nu, master}``, one entry per parameter.  On one rank
every slot is the whole leaf.  On a mesh (:class:`ZeroLayouts`) the
state is ZeRO-1, as the reference lays it out: mu, nu and master live on
``zero_layout(storage, shape, mesh)`` blocks (the param's layout with
every unused mesh axis, the model axis too, pushed onto a free divisible
dim), the gradients arrive on those blocks (the step's reduce-scatter),
the fp32 update runs on the block, and each new parameter is cast to its
storage dtype and gathered back to its storage layout (the all-gather of
the replication).  The update runs in place: the moments, the master
copy and the bf16 parameters keep their buffers across steps (the
reference's jitted step donates them and returns new ones).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Union

import torch

from repro_torch.core import distributed as dist_mod
from repro_torch.core.layout import Layout
from repro_torch.core.replication import from_zero, to_zero, zero_layout


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[Callable[[torch.Tensor], torch.Tensor], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # moment storage dtype; the master copy always stays fp32
    moment_dtype: Any = torch.float32


@dataclasses.dataclass(frozen=True)
class ZeroLayouts:
    """The mesh, each leaf's storage layout and its ZeRO-1 layout."""

    mesh: Any
    storage: Dict[str, Layout]
    zero: Dict[str, Layout]

    @classmethod
    def of(cls, specs: Mapping[str, Any], mesh) -> "ZeroLayouts":
        """From a model's param specs (global shapes and layouts).  A
        layer stack whose dim 0 is on ``pipe`` (the pipeline's specs) keeps
        it: the ZeRO shard over ``data`` is cut from the rank's stage
        slice, so AdamW updates that stage alone."""
        return cls(mesh, {k: s.layout for k, s in specs.items()},
                   {k: zero_layout(s.layout, s.shape, mesh)
                    for k, s in specs.items()})

    def to_zero(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return to_zero(x, self.storage[name], self.zero[name], self.mesh)

    def from_zero(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return from_zero(x, self.zero[name], self.storage[name], self.mesh)


def init_state(params: Mapping[str, torch.Tensor],
               adamw: AdamWConfig = AdamWConfig(),
               zero: Optional[ZeroLayouts] = None) -> Dict[str, Any]:
    """Optimizer state for existing params (this rank's blocks, with
    ``zero``: the state on the ZeRO blocks).  Every slot is a fresh buffer
    (the reference's aliasing fix: mu and nu never share a zeros tensor,
    and master is a copy, never the params' own storage)."""
    def own(n, p):
        p = p.detach().to(torch.float32, copy=True)
        return p if zero is None else zero.to_zero(n, p).clone()
    master = {n: own(n, p) for n, p in params.items()}

    def zeros():
        return {n: torch.zeros(m.shape, dtype=adamw.moment_dtype,
                               device=m.device) for n, m in master.items()}
    device = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": zeros(), "nu": zeros(), "master": master}


def global_norm(tree: Mapping[str, torch.Tensor],
                zero: Optional[ZeroLayouts] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, the leaves taken
    in the reference's pytree order (sorted paths).  With ``zero`` the
    leaves are ZeRO blocks: each leaf's squares are summed over the ranks
    that hold its distinct blocks (a rank that holds a copy of another's
    block counts nothing), in one sum over the mesh."""
    names = sorted(tree, key=lambda n: tuple(n.split(".")))
    sq = [torch.sum(torch.square(tree[n].float())) for n in names]
    if zero is not None:
        mesh = zero.mesh
        mine = [all(mesh.coords[a] == 0 for a in mesh.axis_names
                    if a not in zero.zero[n].mesh_axes_used())
                for n in names]
        vec = torch.stack(sq) * torch.tensor(mine, dtype=torch.float32,
                                             device=sq[0].device)
        sq = list(dist_mod.psum(vec, mesh, mesh.axis_names).unbind())
    total = sq[0]
    for x in sq[1:]:
        total = total + x
    return torch.sqrt(total)


def apply(cfg: AdamWConfig, opt_state: Dict[str, Any],
          grads: Mapping[str, torch.Tensor],
          params: Mapping[str, torch.Tensor],
          zero: Optional[ZeroLayouts] = None):
    """One AdamW step, in place.  Returns ``(params, opt_state, stats)``
    with ``stats = {grad_norm, lr}``; ``params`` (bf16) are rewritten from
    the new fp32 master.  The arithmetic follows the reference's
    expression for expression, in fp32; weight decay applies to every
    leaf with two or more dimensions, which with stacked layer leaves
    includes the (L, D) norms and the (L, H, hd) biases.  With ``zero``
    the gradients and the state are ZeRO blocks, and each new parameter is
    cast to its dtype on the block and gathered back to its storage
    layout."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        opt_state["step"] = step
        lr = (cfg.lr(step) if callable(cfg.lr)
              else torch.tensor(cfg.lr, dtype=torch.float32,
                                device=step.device))
        gnorm = global_norm(grads, zero)
        if cfg.grad_clip:
            # a tensor numerator: ``float / tensor`` would multiply by
            # the reciprocal, which rounds differently
            scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                                / torch.clamp(gnorm, min=1e-12), max=1.0)
        else:
            scale = torch.ones((), dtype=torch.float32, device=step.device)
        stepf = step.float()
        b1c = 1.0 - torch.pow(cfg.b1, stepf)
        b2c = 1.0 - torch.pow(cfg.b2, stepf)
        for name, p in params.items():
            mu, nu = opt_state["mu"][name], opt_state["nu"][name]
            master = opt_state["master"][name]
            g = grads[name].float() * scale
            mu32 = cfg.b1 * mu.float() + (1.0 - cfg.b1) * g
            nu32 = cfg.b2 * nu.float() + (1.0 - cfg.b2) * g * g
            delta = (mu32 / b1c) / (torch.sqrt(nu32 / b2c) + cfg.eps)
            wd = cfg.weight_decay if p.dim() >= 2 else 0.0
            master.sub_(lr * (delta + wd * master))
            mu.copy_(mu32)
            nu.copy_(nu32)
            p.copy_(master if zero is None
                    else zero.from_zero(name, master.to(p.dtype)))
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


def warmup_cosine(peak: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak`` at ``total``."""
    def sched(step: torch.Tensor) -> torch.Tensor:
        s = step.float()
        warm = peak * s / max(1, warmup)
        prog = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup, warm, cos)
    return sched
