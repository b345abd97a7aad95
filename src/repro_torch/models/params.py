"""Parameter specs, initialization and loading of the reference's weights.

Parameters are a flat ``dict[str, Tensor]`` whose keys are the JAX params
pytree's paths joined by dots (``layers.attn.wq``), with the reference's
layouts: stacked layer params lead with ``L``, ``wq`` is ``(D, H, hd)``
and ``wo`` ``(H, hd, D)``; the SSM's ``A``, ``dt_bias`` and ``D_skip``
are fp32, the rest bf16.  Initialization follows the reference's std and
``scaled`` rule (``models/params.py``) on an explicit ``torch.Generator``;
it does not reproduce JAX's random numbers, so tests carry JAX-initialized
weights over with :func:`from_jax`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"   # normal | zeros | ones | scaled | ssm_a | dt_bias
    scale: float = 0.02

    def stacked(self, n: int) -> "ParamSpec":
        """Prepend a layer dimension (the port loops over it)."""
        return dataclasses.replace(self, shape=(n,) + tuple(self.shape))


def _normal(gen, shape, spec, device) -> torch.Tensor:
    # "scaled" specs carry the output-projection std 0.02/sqrt(2L) as scale
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device).mul_(spec.scale)


def _ssm_a(gen, shape, spec, device) -> torch.Tensor:
    # A = -uniform[1, 16]
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    return u.mul_(15.0).add_(1.0).neg_()


def _dt_bias(gen, shape, spec, device) -> torch.Tensor:
    # softplus^-1 of dt in [1e-3, 1e-1]
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return dt + torch.log(-torch.expm1(-dt))


_DRAWS = {"normal": _normal, "scaled": _normal, "ssm_a": _ssm_a,
          "dt_bias": _dt_bias}


def init_param(gen: torch.Generator, spec: ParamSpec,
               device: torch.device, layered: bool = False) -> torch.Tensor:
    """One leaf of ``spec``.  A layer stack (``layered``: its leading dim
    is the layer) is drawn one layer at a time into the leaf, each draw
    in fp32 and scaled in place: gemma3-27b's MLP stacks are 7.2 G
    elements each, whose one fp32 draw and scaled copy (57 GB) would not
    fit on the card beside the 14 GB leaf."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init not in _DRAWS:
        raise ValueError(f"unknown init {spec.init!r}")
    out = torch.empty(spec.shape, dtype=spec.dtype, device=device)
    for piece in (out.unbind(0) if layered else (out,)):
        piece.copy_(_DRAWS[spec.init](gen, piece.shape, spec, device))
    return out


def tree_init(seed: int, specs: Mapping[str, ParamSpec],
              device: torch.device) -> Dict[str, torch.Tensor]:
    """Materialize every spec, in order, from one generator on ``device``;
    the ``layers.*`` leaves are layer stacks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {name: init_param(gen, spec, device,
                             layered=name.startswith("layers."))
            for name, spec in specs.items()}


def _to_tensor(arr: Any) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy's bfloat16 extension dtype: move the bits, not the values
        bits = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def flat_names(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts as one flat dict whose keys are the paths joined by
    dots (the port's parameter names); leaves as they are.  A flat dict
    maps to itself."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(flat_names(val, prefix=name + "."))
        else:
            out[name] = val
    return out


def nest_names(flat: Mapping[str, Any]) -> Dict[str, Any]:
    """The inverse of :func:`flat_names`: the reference's nested pytree
    layout of a flat dict of dotted names."""
    out: Dict[str, Any] = {}
    for name, val in flat.items():
        *parents, leaf = name.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def from_jax(tree: Mapping[str, Any], prefix: str = ""
             ) -> Dict[str, torch.Tensor]:
    """The reference's params pytree (nested dicts of arrays, converted to
    numpy by the caller or here) as the port's flat parameter dict, on the
    CPU.  bf16 leaves are carried bit for bit."""
    return {name: _to_tensor(val)
            for name, val in flat_names(tree, prefix).items()}
