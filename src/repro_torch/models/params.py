"""Parameter specs, initialization and loading of the reference's weights.

Parameters are a flat ``dict[str, Tensor]`` whose keys are the JAX params
pytree's paths joined by dots (``layers.attn.wq``), with the reference's
layouts: stacked layer params lead with ``L``, ``wq`` is ``(D, H, hd)``
and ``wo`` ``(H, hd, D)``; the SSM's ``A``, ``dt_bias`` and ``D_skip``
are fp32, the rest bf16.  Initialization follows the reference's std and
``scaled`` rule (``models/params.py``) on an explicit ``torch.Generator``;
it does not reproduce JAX's random numbers, so tests carry JAX-initialized
weights over with :func:`from_jax`.

On a mesh each spec carries its :class:`~repro_torch.core.layout.Layout`
(the planner's, as the reference's specs do) and each rank keeps its
block of every leaf: :func:`tree_init` draws the whole leaf from the seed,
as on one rank, and keeps the block, so every mesh holds the one-rank
params bit for bit; :func:`from_jax` and :func:`shard_tree` give each
rank its block of a global dict.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.core.layout import Layout


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"   # normal | zeros | ones | scaled | ssm_a | dt_bias
    scale: float = 0.02
    layout: Optional[Layout] = None     # on a mesh: the planner's layout

    def stacked(self, n: int) -> "ParamSpec":
        """Prepend a layer dimension (the port loops over it), left whole
        by the layout."""
        return dataclasses.replace(
            self, shape=(n,) + tuple(self.shape),
            layout=(None if self.layout is None
                    else Layout((None,) + self.layout.dims)))


def plan_layout(plan, mesh, method: str, shape) -> Optional[Layout]:
    """``plan.<method>(shape, mesh)``, the planner's layout of a leaf, or
    None without a plan (one rank)."""
    return None if plan is None else getattr(plan, method)(shape, mesh)


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
              device: torch.device, mesh=None) -> Dict[str, torch.Tensor]:
    """Materialize every spec, in order, from one generator on ``device``
    (made at the first random leaf, so a tree of zeros and ones also
    takes ``device="meta"``); the ``layers.*`` leaves are layer stacks.  With a ``mesh``, each leaf
    is drawn whole and this rank keeps its block of the spec's layout."""
    gen = None
    out = {}
    for name, spec in specs.items():
        if gen is None and spec.init in _DRAWS:
            gen = torch.Generator(device=device).manual_seed(seed)
        leaf = init_param(gen, spec, device,
                          layered=name.startswith("layers."))
        out[name] = (leaf if mesh is None or spec.layout is None
                     else spec.layout.block(leaf, mesh))
    return out


def shard_tree(tree: Mapping[str, torch.Tensor],
               layouts: Mapping[str, Layout], mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's block of each global leaf in its layout."""
    return {name: layouts[name].block(val, mesh)
            for name, val in tree.items()}


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


def from_jax(tree: Mapping[str, Any], prefix: str = "", mesh=None,
             layouts: Optional[Mapping[str, Layout]] = None
             ) -> Dict[str, torch.Tensor]:
    """The reference's params pytree (nested dicts of arrays, converted to
    numpy by the caller or here) as the port's flat parameter dict, on the
    CPU.  bf16 leaves are carried bit for bit.  Given a ``mesh`` and each
    leaf's layout (``Model.param_layouts()``), this rank's blocks."""
    out = {name: _to_tensor(val)
           for name, val in flat_names(tree, prefix).items()}
    return out if mesh is None else shard_tree(out, layouts, mesh)
