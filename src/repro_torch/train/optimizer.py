"""AdamW with fp32 master weights and fp32 moments, ported from the
reference's ``train/optimizer.py`` (implemented from scratch there too).

State = ``{step, mu, nu, master}``, one entry per parameter.  The
reference lays mu, nu and master out ZeRO-1 over the ``data`` axis; here
they stay **replicated** on every rank, which is numerically the same
(the ZeRO layout waits for the distributed substrate, ROADMAP queue 1,
item 7).  The update runs in place: the moments, the master copy and the
bf16 parameters keep their buffers across steps (the reference's jitted
step donates them and returns new ones).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Union

import torch


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


def init_state(params: Mapping[str, torch.Tensor],
               adamw: AdamWConfig = AdamWConfig()) -> Dict[str, Any]:
    """Optimizer state for existing params.  Every slot is a fresh buffer
    (the reference's aliasing fix: mu and nu never share a zeros tensor,
    and master is a copy, never the params' own storage)."""
    def zeros():
        return {n: torch.zeros(p.shape, dtype=adamw.moment_dtype,
                               device=p.device) for n, p in params.items()}
    device = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": zeros(), "nu": zeros(),
            "master": {n: p.detach().to(torch.float32, copy=True)
                       for n, p in params.items()}}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, the leaves taken
    in the reference's pytree order (sorted paths)."""
    total = None
    for name in sorted(tree, key=lambda n: tuple(n.split("."))):
        sq = torch.sum(torch.square(tree[name].float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def apply(cfg: AdamWConfig, opt_state: Dict[str, Any],
          grads: Mapping[str, torch.Tensor],
          params: Mapping[str, torch.Tensor]):
    """One AdamW step, in place.  Returns ``(params, opt_state, stats)``
    with ``stats = {grad_norm, lr}``; ``params`` (bf16) are rewritten from
    the new fp32 master.  The arithmetic follows the reference's
    expression for expression, in fp32; weight decay applies to every
    leaf with two or more dimensions, which with stacked layer leaves
    includes the (L, D) norms and the (L, H, hd) biases."""
    with torch.no_grad():
        step = opt_state["step"] + 1
        opt_state["step"] = step
        lr = (cfg.lr(step) if callable(cfg.lr)
              else torch.tensor(cfg.lr, dtype=torch.float32,
                                device=step.device))
        gnorm = global_norm(grads)
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
            wd = cfg.weight_decay if master.dim() >= 2 else 0.0
            master.sub_(lr * (delta + wd * master))
            mu.copy_(mu32)
            nu.copy_(nu32)
            p.copy_(master)
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
