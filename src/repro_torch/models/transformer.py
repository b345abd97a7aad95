"""The decoder LM, ported from the reference's ``models/transformer.py``:
one :class:`Model` for its six families.  The full-sequence forward and
loss (the train path) of each; the dense, moe, audio and vlm families'
steps on the dense KV cache (the static engine's default) and on the
paged cache; the ssm and hybrid families' on their dense caches.  A moe
layer is a dense layer whose MLP is :func:`repro_torch.models.moe.forward`
(``forward_mesh`` on a mesh); its aux loss is summed over the layers and
enters the loss as ``router_aux_coef * aux / n_layers``.  The audio
family (musicgen over EnCodec codes) is the dense family's stack; the
vlm family (internvl2) is too, with ``vision_embeds`` (B, n_vision, D)
concatenated ahead of the text embeddings (in bf16) by the train forward
and the prefill.  The hybrid family (zamba2) is the ssm family's stack
with one shared attention + MLP block (``shared.*``, one set of weights)
applied after every ``attn_every`` mamba layers: ``n_sites = L //
attn_every`` static groups, then a mamba tail of the rest, as the
reference's ``forward`` and ``decode_step`` split them.  The shared
leaves' gradient is the sum of the sites' cotangents, which autograd
adds in bf16 as they arrive, the last site's first, the order and dtype
of the reference's scan transpose, which carries the closed-over leaf's
cotangent in its own dtype through the reversed group scan.

The reference scans one jitted layer body over the stacked params; PyTorch
runs eagerly, so here a Python loop walks the ``L`` layers.  The train
forward unbinds each stacked ``(L, ...)`` leaf once, so that autograd
stacks the per-layer gradients into one tensor, as JAX's scan transpose
does (indexing ``val[i]`` per layer would make every layer's backward
write a zero tensor the size of the whole stack).  ``remat="full"``, the
reference's default, recomputes each layer in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` around the scanned
body); ``remat="group:G"`` checkpoints each group of G layers and each
layer inside it (the reference's sqrt-L double remat), and runs without
remat when G does not divide L, as the reference does (the ssm and
hybrid families remat under ``"full"`` only, as the reference's
branches; the hybrid checkpoints each mamba layer and, around them, each
site's group with its shared block, as the reference nests them).
Parameters are passed explicitly, as in the reference, so both packages'
steps take the same arguments.  Caches are updated in place
(the reference's jitted steps donate them and return new ones); the steps
still return them.

The dense prefill runs the full-sequence forward, so its MLP takes the
wide fp32 product; the decode steps and the paged prefill chunks take
``glu_mlp``'s bf16 product, as in the reference (``_mlp``).

A config with a sliding window and a local:global pattern (gemma3) keeps
the reference's windowed dense cache: its global layers' ``k_g``/``v_g``
(n_g, B, T, Hkv, hd) and its local layers' O(window) rings ``k_l``/``v_l``
(n_l, B, W, Hkv, hd), W = min(window, T), ring slot j holding the last
position p = j (mod W).

On a ``(data, model)`` mesh (``Model(cfg, mesh=..., plan=...)``, the
plan from :func:`repro_torch.core.planner.plan_for` by default) each rank
holds its blocks of the params in the plan's layouts and runs the
reference's train forward on them: the D-sharded embedding relayed onto
the residual's layout, ``_dense_block``'s routing (head-TP or SP
attention; the local MLP under ``ffn_replicated``, the bf16
gather/reduce-scatter MLP under ``seq_parallel_residual``, the
GSPMD-style MLP otherwise) or ``_ssm_block``'s (the mixer on this rank's
heads, :func:`repro_torch.models.ssm.forward_mesh`), the hybrid's
shared block as the reference's ``_shared_block`` routes it (the mesh
attention, then the bf16 gather/reduce-scatter MLP under
``seq_parallel_residual``, else the GSPMD-style one, on this rank's
column and row blocks), FSDP leaves gathered at use, the vocab-parallel
head and loss.  A vlm batch's vision prefix is split over the batch rows
like the tokens and joins the text on this rank's D-column block before
the residual is relaid onto its layout.  ``forward`` and ``loss_fn``
take the global batch and run this rank's rows (all of them when the
batch cannot split over the data axes, the reference's ``_maybe_batch``).
A moe layer's experts are row-blocked over the model axis and its
router replicated (:func:`repro_torch.models.moe.forward_mesh`).
Serving on a mesh runs for the dense family (qwen2, gemma-2b, qwen3: no
sliding window): each rank holds the whole residual of its rows, the
projections take the plan's layouts (head-TP blocks or whole heads), and
the dense KV cache is this rank's block of ``plan.kv_cache`` (the slots
over the data axes where they divide, the sequence over the model axis,
or over every axis where the slots do not divide), a :class:`MeshCache`
that records where its block sits.  A page pool is sharded by page over
every rank (``attention.page_shard``) under the global block table.
Decode is flash-decoding over the sequence shards (the shard-mode kernel,
the partials all-gathered in rank order, the combine kernel); the
prefill's K/V are gathered over the heads once and each rank keeps its
shard; the logits are gathered whole onto every rank, so greedy tokens
are the same on every rank without a broadcast.  The other families,
and gemma3's windowed rings, still raise on a mesh: the rest of ROADMAP
queue 1, item 13.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.core import distributed as dist_mod
from repro_torch.core import precision
from repro_torch.core.device import resolve_device
from repro_torch.core.layout import Layout, axis_names, batch_block, constrain
from repro_torch.core.planner import plan_for
from repro_torch.core.replication import gathered
from repro_torch.models import attention, layers, moe, ssm
from repro_torch.models.params import (ParamSpec, plan_layout, shard_tree,
                                      tree_init)

Params = Dict[str, torch.Tensor]
# the families whose every layer is attention + MLP (the reference's
# "dense" branches): the dense, moe, audio and vlm ones
ATTENTION_STACKS = ("dense", "moe", "audio", "vlm")
# what serving on a mesh still waits for (ROADMAP queue 1, item 13)
MESH_SERVING_WAITS = (
    "mamba2-780m's long_500k (the SSM state's heads over model), gemma3's "
    "windowed rings, the moe family's routing on every model rank, the "
    "hybrid's states and sites, audio, and the vlm's vision_embeds")


class MeshCache(dict):
    """A rank's block of the dense KV cache on a mesh (``k``, ``v``: (L,
    B_rank, T_rank, Hkv, hd)) and where it sits: the slots split over the
    mesh axes ``rows`` (none when they do not divide), the sequence over
    ``seq_axes``, this rank's first position ``offset``."""

    def __init__(self, tensors, *, rows, seq_axes, offset: int):
        super().__init__(tensors)
        self.rows, self.seq_axes = tuple(rows), tuple(seq_axes)
        self.offset = offset


class Model(nn.Module):
    """Decoder on ``device``, which defaults to the card;
    ``device="cpu"`` runs the plain versions of the kernels.

    - dense family: embed -> L x [RMSNorm -> rotary GQA attention (with
      qk-norm where the config sets it) -> RMSNorm -> gated MLP] ->
      RMSNorm -> unembed, on the dense KV cache (``k``, ``v``; the
      windowed ``k_g``, ``v_g``, ``k_l``, ``v_l`` for gemma3) or the paged
      one;
    - moe family: the dense family's layers with the gated MLP replaced
      by routed experts (top-k of E, capacity-bounded) plus the shared
      experts;
    - ssm family: embed -> L x [RMSNorm -> Mamba2 mixer] -> RMSNorm ->
      unembed, on the dense cache (``conv``, ``ssm``, ``bc_conv``);
    - hybrid family: the ssm family's layers with the shared block
      (RMSNorm -> MHA -> RMSNorm -> gated MLP, one set of weights) after
      every ``attn_every`` of them, on the dense cache holding the L
      layers' states and the ``n_sites`` sites' ``k``/``v``;
    - audio family: the dense family's; vlm family: the dense family's
      behind a prefix of vision embeddings.

    ``ssd_chunk`` is accepted for the reference's signature only: the
    scan's chunk is a tiling choice of its implementations (the CUDA
    kernel walks 64-step chunks, the plain version ``ops.ssd``'s default),
    and the result does not depend on it.  ``remat`` is ``"full"`` (each
    layer recomputed in the backward), ``"group:G"`` (each group of G
    layers and each layer in it) or ``"none"``."""

    def __init__(self, cfg, *, device: Union[str, torch.device] = "cuda",
                 policy: precision.Policy = precision.MIXED,
                 ssd_chunk: int = 256, remat: str = "full", mesh=None,
                 plan=None):
        super().__init__()
        if cfg.family not in ("dense", "moe", "ssm", "hybrid", "audio",
                              "vlm"):
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not a decoder of "
                "this Model (the conv family is models/convnet.py)")
        if mesh is not None and cfg.family == "moe" \
                and cfg.n_experts % mesh.shape.get("model", 1):
            raise ValueError(
                f"{cfg.name} on a mesh: its {cfg.n_experts} experts do not "
                f"split over model = {mesh.shape['model']}")
        if mesh is not None and cfg.family in ("ssm", "hybrid") \
                and cfg.n_ssm_heads % mesh.shape.get("model", 1):
            raise ValueError(
                f"{cfg.name} on a mesh: its {cfg.n_ssm_heads} SSD heads do "
                f"not split over model = {mesh.shape['model']}")
        self.mesh = mesh
        self.plan = (plan if plan is not None or mesh is None
                     else plan_for(cfg, mesh))
        group = remat[len("group:"):] if remat.startswith("group:") else ""
        if remat not in ("full", "none") and not (group.isdigit()
                                                  and int(group) > 0):
            raise ValueError(f"remat={remat!r}; expected 'full', 'none' or "
                             "'group:G' with G >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = policy
        self.remat = remat
        # the reference remats groups only when G divides L, else nothing
        self._group = (int(group) if group and cfg.n_layers % int(group) == 0
                       else 0)
        # layer i's leaves in the dense cache: (name suffix, index), the
        # windowed cache's global layers in k_g/v_g, its local in k_l/v_l
        n_glb = 0
        self._kv_leaf = []
        for i in range(cfg.n_layers):
            if not self._windowed():
                self._kv_leaf.append(("", i))
            elif cfg.is_global_layer(i):
                self._kv_leaf.append(("_g", n_glb))
                n_glb += 1
            else:
                self._kv_leaf.append(("_l", i - n_glb))

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> Dict[str, ParamSpec]:
        """Every leaf's spec; on a mesh with the plan's layouts (the
        reference's ``param_specs`` and ``_layer_specs``)."""
        cfg, plan, mesh = self.cfg, self.plan, self.mesh
        D, V, F, L = cfg.d_model, cfg.padded_vocab, cfg.d_ff, cfg.n_layers
        out_scale = 0.02 / max(1, 2 * L) ** 0.5
        lay = functools.partial(plan_layout, plan, mesh)
        vec = ParamSpec((D,), init="ones", layout=lay("vector", (D,)))
        mlp = {
            "mlp.gate": ParamSpec((D, F), layout=lay("ffn_in", (D, F))),
            "mlp.in": ParamSpec((D, F), layout=lay("ffn_in", (D, F))),
            "mlp.out": ParamSpec((F, D), init="scaled", scale=out_scale,
                                 layout=lay("ffn_out", (F, D)))}
        attn = {"ln1": vec, "ln2": vec,
                **{f"attn.{k}": s for k, s in
                   attention.attn_specs(cfg, plan, mesh).items()}}
        shared = {}
        if cfg.family in ("ssm", "hybrid"):
            layer = {"ln1": vec, **{f"ssm.{k}": s for k, s in
                                    ssm.ssm_specs(cfg, plan, mesh).items()}}
            if cfg.family == "hybrid":
                # zamba2's shared block: one set of weights, unstacked
                shared = {f"shared.{k}": s
                          for k, s in {**attn, **mlp}.items()}
        else:
            layer = dict(attn)
            layer.update({f"moe.{k}": s for k, s in
                          moe.moe_specs(cfg, plan, mesh).items()}
                         if cfg.family == "moe" else mlp)
        return {
            "embed": ParamSpec((V, D), layout=lay("embed", (V, D))),
            "unembed": ParamSpec((D, V), layout=lay("unembed", (D, V))),
            "final_norm": ParamSpec((D,), init="ones",
                                    layout=lay("vector", (D,))),
            **{f"layers.{k}": s.stacked(L) for k, s in layer.items()},
            **shared,
        }

    def param_layouts(self) -> Dict[str, Layout]:
        """Each leaf's storage layout on the mesh."""
        if not hasattr(self, "_layouts"):
            self._layouts = {k: s.layout
                             for k, s in self.param_specs().items()}
        return self._layouts

    def init(self, seed: int) -> Params:
        """Random weights from ``seed`` on the model's device; on a mesh,
        this rank's blocks of the one-rank weights."""
        return tree_init(seed, self.param_specs(), self.device, self.mesh)

    def shard(self, params: Params) -> Params:
        """This rank's blocks of global params (the model's device)."""
        params = {k: v.to(self.device) for k, v in params.items()}
        return (params if self.mesh is None
                else shard_tree(params, self.param_layouts(), self.mesh))

    # ------------------------------------------------------------------
    # the mesh
    # ------------------------------------------------------------------
    def rows_split(self, batch: int) -> bool:
        """Whether a global batch of ``batch`` rows splits over the plan's
        batch axes (else every rank runs all of them)."""
        n = math.prod(self.mesh.shape[a] for a in self.plan.batch_axes)
        return batch % n == 0 and batch >= n

    def row_axes(self, batch: int) -> Tuple[str, ...]:
        """The mesh axes a global batch of ``batch`` rows splits over:
        the plan's batch axes, or none (one rank, or rows that do not
        split).  Every layout of a forward on the mesh is taken from this
        value, which the forward passes down: nothing of it is kept on
        the model, so a recompute in the backward sees its own forward's
        rows."""
        if self.mesh is None or not self.rows_split(batch):
            return ()
        return self.plan.batch_axes

    def grad_split_axes(self, name: str, batch: int) -> Tuple[str, ...]:
        """The mesh axes over which this rank's gradient of leaf ``name``
        is a share (the work using it was split there), for a global
        batch of ``batch`` rows: the batch axes when the rows split, and
        the model axis for a leaf the model axis replicates wherever each
        rank runs its own part of the sequence or heads with it (the norms
        on sequence-sharded residuals, every SP weight, qk-norm scales on
        a rank's own heads, a moe router, whose gradient each rank takes
        from its own experts).  A leaf every rank of the axis uses on the
        same values (the norms and the local MLP, or a moe layer's shared
        experts, on a replicated residual under
        ``seq_parallel_residual=False``) is whole on each; the hybrid's
        shared MLP is never local (each rank takes its block of it)."""
        plan, mesh = self.plan, self.mesh
        axes = list(self.row_axes(batch))
        tp = plan.tp_axis
        if mesh.shape.get(tp, 1) > 1 and \
                tp not in self.param_layouts()[name].mesh_axes_used():
            leaf = name.split(".")[-1]
            same = not plan.seq_parallel_residual and (
                leaf in ("ln1", "ln2", "final_norm")
                or (plan.ffn_replicated and name.startswith("layers.")
                    and (".mlp." in name or ".moe.shared_" in name)))
            if not same:
                axes.append(tp)
        return tuple(axes)

    def _servable(self, what: str) -> None:
        """On a mesh the serving entry points run for the dense family
        (no sliding window); every other family raises, naming what
        ROADMAP queue 1, item 13 still waits for."""
        cfg = self.cfg
        if self.mesh is not None and (cfg.family != "dense"
                                      or self._windowed()):
            raise NotImplementedError(
                f"{what} on a mesh: serving on a mesh runs the dense family "
                f"(qwen2, gemma-2b, qwen3); {cfg.name} ({cfg.family}"
                f"{', windowed' if self._windowed() else ''}) waits for the "
                f"rest of ROADMAP queue 1, item 13: {MESH_SERVING_WAITS}; "
                "serve it from a Model without a mesh")

    def _hidden(self, rows: Tuple[str, ...]) -> Layout:
        """The residual's layout for a batch split over ``rows`` (the
        batch axes dropped when the rows do not split)."""
        lay = self.plan.hidden()
        return Layout((rows or None,) + lay.dims[1:])

    def _use(self, val: torch.Tensor, storage: Layout,
             rows: Tuple[str, ...]) -> torch.Tensor:
        """A leaf (or a layer's slice) at its use layout: gathered over the
        FSDP axis where it is stored sharded there (its gradient comes
        back summed over the ``rows`` the batch split over)."""
        plan = self.plan
        if not plan.fsdp or plan.fsdp_axis not in storage.mesh_axes_used():
            return val
        return gathered(val, storage, storage.drop_axis(plan.fsdp_axis),
                        self.mesh, split=rows)

    def _use_layer(self, lp: dict, rows: Tuple[str, ...]) -> dict:
        """One layer's params (nested as :meth:`_layer` nests them) at
        their use layouts."""
        lays = {name[len("layers."):]: Layout(lay.dims[1:])
                for name, lay in self.param_layouts().items()
                if name.startswith("layers.")}
        return {k: ({kk: self._use(vv, lays[f"{k}.{kk}"], rows)
                     for kk, vv in v.items()}
                    if isinstance(v, dict) else self._use(v, lays[k], rows))
                for k, v in lp.items()}

    def _shared(self, params: Params, rows: Tuple[str, ...] = ()) -> dict:
        """The hybrid's shared block as the nested dict the blocks take
        (``ln1``, ``ln2``, ``attn``, ``mlp``); on a mesh at their use
        layouts."""
        lays = self.param_layouts() if self.mesh is not None else {}
        out: dict = {}
        for name, val in params.items():
            if not name.startswith("shared."):
                continue
            if self.mesh is not None:
                val = self._use(val, lays[name], rows)
            parts = name.split(".")[1:]
            if len(parts) == 1:
                out[parts[0]] = val
            else:
                out.setdefault(parts[0], {})[parts[1]] = val
        return out

    def _embed(self, params: Params, tokens: torch.Tensor,
               rows: Tuple[str, ...], vision_embeds=None) -> torch.Tensor:
        """Embed -> bf16 residual, a vlm's ``vision_embeds`` (B, n_vision,
        D) concatenated ahead of the text in the embedding's dtype (the
        reference's ``_embed``): on a mesh, this rank's rows (those of its
        coordinate on ``rows``) against its D-column block, the prefix's
        block of the same rows and columns joined to them, relayed onto
        the residual's layout (an all-to-all over the model axis onto the
        sequence shards)."""
        cfg = self.cfg
        if self.mesh is None:
            x = layers.embed(tokens, params["embed"], scale=cfg.emb_scale)
            if vision_embeds is not None:
                x = torch.cat([vision_embeds.to(x.dtype), x], 1)
            return x.to(torch.bfloat16)
        plan, mesh = self.plan, self.mesh
        table = self._use(params["embed"], self.param_layouts()["embed"],
                          rows)
        cols = Layout((rows or None, None, plan.tp_axis))
        x = layers.embed_shard_map(
            batch_block(tokens, mesh, rows), table, mesh,
            tp_axis=plan.tp_axis, scale=cfg.emb_scale)
        if vision_embeds is not None:
            x = torch.cat([cols.block(vision_embeds, mesh).to(x.dtype), x],
                          1)
        return constrain(x.to(torch.bfloat16), self._hidden(rows), mesh,
                         src=cols)

    @staticmethod
    def _layer(params: Params, i: int) -> dict:
        """Layer ``i``'s params as the nested dict the blocks take."""
        lp: dict = {}
        for name, val in params.items():
            if name.startswith("layers."):
                parts = name.split(".")[1:]
                if len(parts) == 1:
                    lp[parts[0]] = val[i]
                else:
                    lp.setdefault(parts[0], {})[parts[1]] = val[i]
        return lp

    @staticmethod
    def _unbind_layers(params: Params) -> list:
        """Every layer's params as the nested dicts the blocks take, from
        one ``unbind`` of each stacked leaf."""
        out: list = []
        for name, val in params.items():
            if not name.startswith("layers."):
                continue
            parts = name.split(".")[1:]
            for i, piece in enumerate(torch.unbind(val, 0)):
                if len(out) <= i:
                    out.append({})
                if len(parts) == 1:
                    out[i][parts[0]] = piece
                else:
                    out[i].setdefault(parts[0], {})[parts[1]] = piece
        return out

    def _window(self, i: int):
        """Layer ``i``'s sliding window (gemma3's local layers), or None;
        the reference's global layers take a window past the sequence,
        which masks nothing."""
        cfg = self.cfg
        if cfg.window is None or cfg.is_global_layer(i):
            return None
        return cfg.window

    def _windowed(self) -> bool:
        """gemma3's interleaved local/global layers: the local layers keep
        an O(window) ring instead of an O(seq) cache."""
        cfg = self.cfg
        return bool(cfg.window and cfg.local_global_pattern
                    and cfg.family in ATTENTION_STACKS)

    def _dense_block(self, x, lp, window, with_cache: bool = False,
                     rows: Tuple[str, ...] = ()):
        """One dense or moe layer of the full-sequence forward: ``(x, the
        moe layer's aux loss or None, (k, v) with ``with_cache`` else
        None)``.  On a mesh ``rows`` are the axes the batch splits over
        (:meth:`row_axes`)."""
        cfg = self.cfg
        if self.mesh is not None:
            x, aux = self._dense_block_mesh(x, self._use_layer(lp, rows),
                                            window, rows)
            return x, aux, None
        h = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
        a = attention.forward(h, lp["attn"], cfg, policy=self.policy,
                              window=window, with_cache=with_cache)
        a, kv = a if with_cache else (a, None)
        x = x + a
        h = layers.rms_norm(x, lp["ln2"], cfg.norm_eps)
        aux = None
        if cfg.family == "moe":
            f, aux = moe.forward(h, lp["moe"], cfg, policy=self.policy)
        else:
            f = self._mlp(h, lp, wide=True)
        return x + f, aux, kv

    def _dense_block_mesh(self, x, lp, window, rows: Tuple[str, ...]):
        """``_dense_block`` on this rank's blocks (the reference's routing:
        a moe layer's experts on this rank, the local MLP under
        ``ffn_replicated``, the bf16 shard_map MLP under
        ``seq_parallel_residual``, else the GSPMD-style one): ``(x, the
        moe layer's aux loss or None)``."""
        cfg, plan, mesh = self.cfg, self.plan, self.mesh
        h = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
        x = x + attention.forward(h, lp["attn"], cfg, policy=self.policy,
                                  window=window, mesh=mesh, plan=plan,
                                  hidden=self._hidden(rows))
        h = layers.rms_norm(x, lp["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            f, aux = moe.forward_mesh(h, lp["moe"], cfg, plan, mesh,
                                      rows=rows, policy=self.policy)
            return x + f, aux
        w = (lp["mlp"]["gate"], lp["mlp"]["in"], lp["mlp"]["out"])
        if plan.ffn_replicated:
            f = layers.glu_mlp(h, *w, act=cfg.act, policy=self.policy)
        elif plan.seq_parallel_residual:
            f = layers.glu_mlp_shardmap(h, *w, act=cfg.act, mesh=mesh,
                                        plan=plan, policy=self.policy)
        else:
            f = layers.glu_mlp(h, *w, act=cfg.act, policy=self.policy,
                               mesh=mesh, tp_axis=plan.tp_axis)
        return x + f, None

    def _mlp(self, h, lp, wide: bool = False):
        """The gated MLP, or a moe layer's experts (its aux dropped: the
        serving steps).  The full-sequence forward (``_dense_block``)
        takes the ``wide`` form, as the reference's default one-device plan
        runs ``glu_mlp_shardmap`` there; the paged steps take ``glu_mlp``'s
        rounding, as the reference's do.  Serving on a mesh, on a whole
        residual, the MLP is local where the plan keeps it replicated
        (``ffn_replicated``), else this rank's column and row blocks with
        the fp32 shares summed over the model axis in rank order, rounded
        as on one rank (``g`` and ``h`` not pinned)."""
        if self.cfg.family == "moe":
            return moe.forward(h, lp["moe"], self.cfg, policy=self.policy)[0]
        tp = self.mesh is not None and not self.plan.ffn_replicated
        return layers.glu_mlp(h, lp["mlp"]["gate"], lp["mlp"]["in"],
                              lp["mlp"]["out"], act=self.cfg.act,
                              policy=self.policy, wide=wide, pinned=False,
                              mesh=self.mesh if tp else None,
                              tp_axis=self.plan.tp_axis if tp else None)

    def _head(self, params: Params, x: torch.Tensor,
              last_only: bool = False,
              rows: Tuple[str, ...] = ()) -> torch.Tensor:
        """Final norm and unembed: fp32 logits; on a mesh this rank's
        vocab block (B, S, V/tp), the residual gathered over the sequence
        (or entering the vocab split whole) for it, ``rows`` being the
        axes the batch splits over."""
        x = layers.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        if self.mesh is not None:
            mesh, tp = self.mesh, self.plan.tp_axis
            x = (dist_mod.all_gather_ad(x, mesh, tp, 1)
                 if self.plan.seq_parallel_residual
                 else dist_mod.copy_ad(x, mesh, tp))
            w = self._use(params["unembed"], self.param_layouts()["unembed"],
                          rows)
        else:
            w = params["unembed"]
        if last_only:
            x = x[:, -1:, :]
        return layers.unembed(x, w, policy=self.policy)

    # ------------------------------------------------------------------
    # serving on a mesh (the dense family)
    # ------------------------------------------------------------------
    def _kv_place(self, lay: Layout, seq_len: int):
        """(rows, seq_axes, offset) of this rank's block of a dense cache
        in ``lay`` (``plan.kv_cache``) over ``seq_len`` positions."""
        rows = axis_names(lay.dims[1])
        seq_axes = axis_names(lay.dims[2])
        n = math.prod(self.mesh.shape[a] for a in seq_axes)
        if seq_len % n:
            raise ValueError(
                f"a dense cache of {seq_len} positions does not split over "
                f"the {n} sequence shards of {seq_axes}")
        return rows, seq_axes, attention.flat_index(
            self.mesh, seq_axes) * (seq_len // n)

    def _pool_axes(self) -> Tuple[str, ...]:
        """A page pool's shards: every axis (the pool has no batch dim)."""
        return tuple(self.plan.batch_axes) + (self.plan.tp_axis,)

    def _embed_whole(self, params: Params, tokens: torch.Tensor
                     ) -> torch.Tensor:
        """Serving's residual: ``tokens`` (this rank's rows) against the
        table's column block, gathered whole over the model axis, bf16."""
        cfg, plan, mesh = self.cfg, self.plan, self.mesh
        table = self._use(params["embed"], self.param_layouts()["embed"], ())
        if table.shape[1] == cfg.d_model:
            x = layers.embed(tokens, table, scale=cfg.emb_scale)
            return x.to(torch.bfloat16)
        x = layers.embed_shard_map(tokens, table, mesh, tp_axis=plan.tp_axis,
                                   scale=cfg.emb_scale)
        return dist_mod.all_gather(x.to(torch.bfloat16), mesh, plan.tp_axis,
                                   2)

    def _head_whole(self, params: Params, x: torch.Tensor,
                    rows: Tuple[str, ...]) -> torch.Tensor:
        """Serving's logits, whole on every rank: this rank's vocab block
        gathered over the model axis, its rows over ``rows``."""
        cfg, plan, mesh = self.cfg, self.plan, self.mesh
        x = layers.rms_norm(x, params["final_norm"], cfg.norm_eps)
        w = self._use(params["unembed"], self.param_layouts()["unembed"], ())
        logits = layers.unembed(x, w, policy=self.policy)
        if w.shape[1] != cfg.padded_vocab:
            logits = dist_mod.all_gather(logits, mesh, plan.tp_axis, 2)
        return dist_mod.all_gather(logits, mesh, rows, 0) if rows else logits

    def _serve_layers(self, params: Params, x, attend, wide: bool = False):
        """The serving stack of the attention families, on one rank or a
        mesh: per layer, ``attend(i, h, attn params)`` (this step's
        attention on layer i's cache) then the MLP (:meth:`_mlp`)."""
        cfg = self.cfg
        for i in range(cfg.n_layers):
            lp = self._layer(params, i)
            if self.mesh is not None:
                lp = self._use_layer(lp, ())
            h = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
            x = x + attend(i, h, lp["attn"])
            h = layers.rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + self._mlp(h, lp, wide)
        return x

    def _prefill_mesh(self, params, tokens, last_only, cache, slot):
        """:meth:`prefill` on a mesh: the prompt's rows on every rank of
        the model axis (a one-prompt prefill into a cache row on every
        rank), the wide MLP as on one rank; each layer's K/V gathered over
        the heads and this rank's sequence shard kept: written into its
        block of ``cache`` where it holds row ``slot``, or returned as
        the block of a new :class:`MeshCache` (the prompt's length must
        split over the sequence shards)."""
        B, S = tokens.shape
        plan, mesh = self.plan, self.mesh
        if cache is None:
            rows = self.row_axes(B)
            lay = plan.kv_cache(B, mesh)
            _, seq_axes, offset = self._kv_place(lay, S)
            n_loc = S // math.prod(mesh.shape[a] for a in seq_axes)
            row_lo, keep = 0, True
            out = {"k": [], "v": []}
        else:
            if not isinstance(cache, MeshCache):
                raise TypeError("prefill on a mesh writes into a MeshCache "
                                "(Model.init_cache on the same mesh)")
            rows = ()
            seq_axes, offset = cache.seq_axes, cache.offset
            n_loc = cache["k"].shape[2]
            b_loc = cache["k"].shape[1]
            row_lo = (attention.flat_index(mesh, cache.rows) * b_loc
                      if cache.rows else 0)
            keep = row_lo <= slot < row_lo + b_loc
        n_own = max(0, min(S - offset, n_loc))

        def attend(i, h, p):
            y, (k, v) = attention.prefill_mesh(h, p, self.cfg, plan=plan,
                                               mesh=mesh, policy=self.policy)
            for name, val in (("k", k), ("v", v)):
                if cache is None:
                    out[name].append(val[:, offset:offset + n_loc]
                                     .to(torch.bfloat16))
                elif keep and n_own:
                    cache[name][i, slot - row_lo, :n_own].copy_(
                        val[0, offset:offset + n_own])
            return y

        x = self._serve_layers(
            params, self._embed_whole(params, batch_block(tokens, mesh,
                                                          rows)),
            attend, wide=True)
        logits = self._head_whole(params, x[:, -1:] if last_only else x,
                                  rows)
        if cache is None:
            cache = MeshCache({name: torch.stack(vals)
                               for name, vals in out.items()},
                              rows=rows, seq_axes=seq_axes, offset=offset)
        return logits, cache

    def _decode_step_mesh(self, params, cache, tokens, pos):
        """:meth:`decode_step` on a mesh: this rank's rows of the slots
        against its block of the dense cache (``attention.decode_mesh``);
        the whole (B, 1, V) logits on every rank."""
        if not isinstance(cache, MeshCache):
            raise TypeError("decode_step on a mesh takes a MeshCache "
                            "(Model.init_cache or prefill on the same mesh)")
        B = tokens.shape[0]
        rows = cache.rows
        pos = batch_block(pos.expand(B), self.mesh, rows)

        def attend(i, h, p):
            return attention.decode_mesh(
                h, p, self.cfg, cache["k"][i], cache["v"][i], pos,
                plan=self.plan, mesh=self.mesh, seq_axes=cache.seq_axes,
                offset=cache.offset, policy=self.policy)

        x = self._serve_layers(params, self._embed_whole(
            params, batch_block(tokens, self.mesh, rows)), attend)
        return self._head_whole(params, x, rows), cache

    def _paged_step_mesh(self, params, cache, tokens, pos=None,
                         table_row=None, start: int = 0):
        """The paged steps on a mesh, every rank running every row against
        its shard of the pool: a decode step (``pos``) or one prefill
        chunk (``table_row``, ``start``)."""
        plan, mesh, axes = self.plan, self.mesh, self._pool_axes()
        if table_row is not None:       # the chunk's live pages, read once
            page = cache["k_pages"].shape[2]
            live = table_row[:-(-(start + tokens.shape[1]) // page)].tolist()

        def attend(i, h, p):
            kp, vp = cache["k_pages"][i], cache["v_pages"][i]
            if table_row is not None:
                return attention.prefill_chunk_paged_mesh(
                    h, p, self.cfg, kp, vp, table_row, start, plan=plan,
                    mesh=mesh, seq_axes=axes, live_pages=live,
                    policy=self.policy)
            return attention.decode_paged_mesh(
                h, p, self.cfg, kp, vp, cache["table"],
                pos.expand(tokens.shape[0]), plan=plan, mesh=mesh,
                seq_axes=axes, policy=self.policy)

        x = self._serve_layers(params, self._embed_whole(params, tokens),
                               attend)
        return self._head_whole(params, x, ()), cache

    # ------------------------------------------------------------------
    # block-paged KV cache
    # ------------------------------------------------------------------
    def paged_supported(self) -> bool:
        """Paged decode covers the dense, moe, audio and vlm families'
        uniform full-attention layers: no sliding windows, no logit
        softcap (not the hybrid: the reference's neither)."""
        cfg = self.cfg
        return (cfg.family in ATTENTION_STACKS and cfg.window is None
                and cfg.attn_softcap is None)

    def _pages(self, num_pages: int, page_size: int, device=None
               ) -> Dict[str, torch.Tensor]:
        """The pool of ``num_pages`` pages; on a mesh this rank's shard of
        it (``attention.local_pages``)."""
        self._servable("the paged cache")
        device = self.device if device is None else device
        cfg = self.cfg
        if not self.paged_supported():
            raise ValueError(f"paged decode unsupported for family="
                             f"{cfg.family!r} window={cfg.window} "
                             f"softcap={cfg.attn_softcap}")
        if self.mesh is not None:
            num_pages = attention.local_pages(num_pages, self.mesh.size)
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
                 cfg.d_head)
        return {"k_pages": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device),
                "v_pages": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device)}

    def init_paged_cache(self, batch: int, seq_len: int,
                         page_size: int = 64, device=None
                         ) -> Dict[str, torch.Tensor]:
        """Page pool plus a slot-major table: slot b owns pages
        ``[b*nb, (b+1)*nb)``, ``nb = ceil(seq_len / page_size)``.  Each
        cache constructor takes ``device="meta"`` for its stand-in (shapes
        and dtypes, no storage)."""
        nb = -(-seq_len // page_size)
        # on a mesh page 0 is the NULL page every rank keeps for itself
        first = 0 if self.mesh is None else 1
        cache = self._pages(batch * nb + first, page_size, device)
        cache["table"] = torch.arange(
            first, batch * nb + first, dtype=torch.int32,
            device=self.device if device is None else device
        ).reshape(batch, nb)
        return cache

    def init_paged_pool(self, num_pages: int, page_size: int = 64,
                        device=None) -> Dict[str, torch.Tensor]:
        """Bare page pool for a continuous-batching allocator; page 0 is
        the NULL page that idle slots and unallocated table tails use."""
        return self._pages(num_pages, page_size, device)

    def prefill_chunk_paged(self, params: Params, cache: dict,
                            tokens: torch.Tensor, table_row: torch.Tensor,
                            start: int) -> Tuple[torch.Tensor, dict]:
        """One end-padded prefill chunk ``tokens`` (1, C) for ONE sequence
        whose logical->physical row is ``table_row``, ``start`` being the
        absolute position of ``tokens[0, 0]``.  Returns fp32 logits
        (1, C, V) and ``cache``, whose pages were updated in place."""
        self._servable("prefill_chunk_paged")
        if self.mesh is not None:
            return self._paged_step_mesh(params, cache, tokens, start=start,
                                         table_row=table_row)
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], scale=cfg.emb_scale)

        def attend(i, h, p):
            return attention.prefill_chunk_paged(
                h, p, cfg, cache["k_pages"][i], cache["v_pages"][i],
                table_row, start, policy=self.policy)[0]

        x = self._serve_layers(params, x.to(torch.bfloat16), attend)
        return self._head(params, x), cache

    def decode_step_paged(self, params: Params, cache: dict,
                          tokens: torch.Tensor, pos: torch.Tensor
                          ) -> Tuple[torch.Tensor, dict]:
        """One token per slot, ``tokens`` (B, 1) at positions ``pos``
        (scalar or (B,)), against ``cache["table"]``.  Returns fp32 logits
        (B, 1, V) and ``cache``, whose pages were updated in place."""
        self._servable("decode_step_paged")
        if self.mesh is not None:
            return self._paged_step_mesh(params, cache, tokens, pos=pos)
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], scale=cfg.emb_scale)

        def attend(i, h, p):
            return attention.decode_paged(
                h, p, cfg, cache["k_pages"][i], cache["v_pages"][i],
                cache["table"], pos, policy=self.policy)[0]

        x = self._serve_layers(params, x.to(torch.bfloat16), attend)
        return self._head(params, x), cache

    # ------------------------------------------------------------------
    # full sequence and the dense cache
    # ------------------------------------------------------------------
    def _ssm_block(self, x, lp, with_state: bool = False,
                   rows: Tuple[str, ...] = ()):
        """One ssm layer of the full-sequence forward: ``(x, the mixer's
        (conv, ssm, bc_conv) state or None)``; on a mesh (no state) the
        mixer on this rank's heads, ``rows`` being the axes the batch
        splits over."""
        cfg = self.cfg
        if self.mesh is not None:
            lp = self._use_layer(lp, rows)
            h = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
            return x + ssm.forward_mesh(h, lp["ssm"], cfg, self.plan,
                                        self.mesh, policy=self.policy), None
        h = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, state = ssm.forward(h, lp["ssm"], cfg, policy=self.policy,
                               with_state=with_state)
        return x + y, state

    def _ssm_layer(self, x, lp, rows: Tuple[str, ...] = ()):
        return self._ssm_block(x, lp, False, rows)[0]

    def _shared_block(self, x, sp, with_cache: bool = False,
                      rows: Tuple[str, ...] = ()):
        """The hybrid's shared attention + MLP block at one site (the
        reference's ``_shared_block``): ``(x, (k, v) with ``with_cache``
        else None)``.  On one rank its MLP is the reference's
        replicated-residual form (``pinned``), whose one-device plan also
        runs the mixer in fp32 as :func:`ssm.forward` does; on a mesh
        (no cache) the reference's routing on this rank's blocks."""
        cfg = self.cfg
        if self.mesh is not None:
            return self._shared_block_mesh(x, sp, rows), None
        h = layers.rms_norm(x, sp["ln1"], cfg.norm_eps)
        a = attention.forward(h, sp["attn"], cfg, policy=self.policy,
                              with_cache=with_cache)
        a, kv = a if with_cache else (a, None)
        x = x + a
        h = layers.rms_norm(x, sp["ln2"], cfg.norm_eps)
        w = sp["mlp"]
        f = layers.glu_mlp(h, w["gate"], w["in"], w["out"], act=cfg.act,
                           policy=self.policy, pinned=True)
        return x + f, kv

    def _shared_block_mesh(self, x, sp, rows: Tuple[str, ...]):
        """``_shared_block`` on this rank's blocks: the mesh attention,
        then the bf16 gather/reduce-scatter MLP under
        ``seq_parallel_residual``, else the GSPMD-style one, as the
        reference routes it (never the local MLP: its ``_shared_block``
        has no ``ffn_replicated`` branch).  Where the plan keeps the MLP
        replicated (``ffn_replicated``), this rank takes its column and
        row blocks of it, the split the reference's ``shard_map`` and
        ``h_layout`` impose."""
        cfg, plan, mesh = self.cfg, self.plan, self.mesh
        h = layers.rms_norm(x, sp["ln1"], cfg.norm_eps)
        x = x + attention.forward(h, sp["attn"], cfg, policy=self.policy,
                                  mesh=mesh, plan=plan,
                                  hidden=self._hidden(rows))
        h = layers.rms_norm(x, sp["ln2"], cfg.norm_eps)
        w = (sp["mlp"]["gate"], sp["mlp"]["in"], sp["mlp"]["out"])
        if plan.ffn_replicated:
            n, r = mesh.shape[plan.tp_axis], mesh.coords[plan.tp_axis]
            f_loc = cfg.d_ff // n
            cols = slice(r * f_loc, (r + 1) * f_loc)
            w = (w[0][:, cols], w[1][:, cols], w[2][cols])
        if plan.seq_parallel_residual:
            f = layers.glu_mlp_shardmap(h, *w, act=cfg.act, mesh=mesh,
                                        plan=plan, policy=self.policy)
        else:
            f = layers.glu_mlp(h, *w, act=cfg.act, policy=self.policy,
                               mesh=mesh, tp_axis=plan.tp_axis)
        return x + f

    def _hybrid_group(self, x, lps, sp, rows: Tuple[str, ...], remat: bool):
        """One site's group: its mamba layers (each checkpointed when
        ``remat``), then the shared block."""
        for lp in lps:
            x = (checkpoint(self._ssm_layer, x, lp, rows, use_reentrant=False)
                 if remat else self._ssm_layer(x, lp, rows))
        return self._shared_block(x, sp, False, rows)[0]

    def _hybrid_stack(self, params: Params, tokens: torch.Tensor,
                      write_state=None, write_kv=None) -> torch.Tensor:
        """Embed -> ``n_sites`` groups of ``attn_every`` mamba layers and
        the shared block -> the mamba tail (the reference's static
        groups).  Under ``remat="full"`` while autograd records, each
        mamba layer is checkpointed and so is each group around them, as
        the reference nests its checkpoints.  Given ``write_state`` and
        ``write_kv``, layer i's (conv, ssm, bc_conv) state goes to
        ``write_state(i, state)`` and site s's rotated keys and values to
        ``write_kv(s, (k, v))``.  Returns the residual (B, S, D) in
        bf16."""
        cfg = self.cfg
        rows = self.row_axes(tokens.shape[0])
        x = self._embed(params, tokens, rows)
        lps = self._unbind_layers(params)
        sp = self._shared(params, rows)
        every = cfg.attn_every
        n_sites = cfg.n_layers // every
        remat = (self.remat == "full" and torch.is_grad_enabled()
                 and write_state is None)
        for s in range(n_sites):
            group = lps[s * every:(s + 1) * every]
            if write_state is not None:
                for i, lp in enumerate(group, start=s * every):
                    x, state = self._ssm_block(x, lp, True, rows)
                    write_state(i, state)
                x, kv = self._shared_block(x, sp, True, rows)
                write_kv(s, kv)
            elif remat:
                x = checkpoint(self._hybrid_group, x, group, sp, rows, True,
                               use_reentrant=False)
            else:
                x = self._hybrid_group(x, group, sp, rows, False)
        for i, lp in enumerate(lps[n_sites * every:], start=n_sites * every):
            if write_state is not None:
                x, state = self._ssm_block(x, lp, True, rows)
                write_state(i, state)
            elif remat:
                x = checkpoint(self._ssm_layer, x, lp, rows,
                               use_reentrant=False)
            else:
                x = self._ssm_layer(x, lp, rows)
        return x

    def _mixer_stack(self, params: Params, tokens: torch.Tensor,
                     write_state=None) -> torch.Tensor:
        """Embed -> L x mixer, each layer checkpointed under
        ``remat="full"`` while autograd records; given ``write_state``,
        each layer's state goes to ``write_state(i, (conv, ssm,
        bc_conv))``.  Returns the residual stream (B, S, D) in bf16."""
        rows = self.row_axes(tokens.shape[0])
        x = self._embed(params, tokens, rows)
        remat = self.remat == "full" and torch.is_grad_enabled()
        for i, lp in enumerate(self._unbind_layers(params)):
            if write_state is not None:
                x, state = self._ssm_block(x, lp, True, rows)
                write_state(i, state)
            elif remat:
                x = checkpoint(self._ssm_layer, x, lp, rows,
                               use_reentrant=False)
            else:
                x = self._ssm_layer(x, lp, rows)
        return x

    def forward(self, params: Params, tokens: torch.Tensor,
                vision_embeds=None, with_cache: bool = False,
                last_only: bool = False):
        """Full-sequence forward: (fp32 logits (B, S or 1, V), the aux loss
        (the moe layers' sum; 0 for the other families), the stacked
        per-layer caches or None).  A vlm's ``vision_embeds`` (B,
        n_vision, D) lead the sequence (S = n_vision + the text's).  With
        ``with_cache`` the dense, moe, audio and vlm families return ``(k,
        v)``, each (L, B, S, Hkv, hd) in bf16, the ssm family ``(conv,
        ssm, bc_conv)`` and the hybrid ``((conv, ssm, bc_conv), (k, v))``,
        its K/V (n_sites, B, S, Hkv, hd)."""
        if with_cache:
            self._servable("forward with_cache")
            if self.mesh is not None:
                logits, cache = self.prefill(params, tokens,
                                             last_only=last_only)
                zero = torch.zeros((), dtype=torch.float32,
                                   device=logits.device)
                return logits, zero, (cache["k"], cache["v"])
        layer_caches, site_caches = [], []
        write = ((lambda i, c: layer_caches.append(c)) if with_cache
                 else None)
        aux = None
        family = self.cfg.family
        if family == "ssm":
            x = self._mixer_stack(params, tokens, write)
        elif family == "hybrid":
            x = self._hybrid_stack(
                params, tokens, write,
                (lambda s, c: site_caches.append(c)) if with_cache else None)
        else:
            x, aux = self._dense_stack(params, tokens, write, vision_embeds)
        caches = (tuple(torch.stack(t) for t in zip(*layer_caches))
                  if with_cache else None)
        if with_cache and family == "hybrid":
            caches = (caches, tuple(torch.stack(t)
                                    for t in zip(*site_caches)))
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return (self._head(params, x, last_only,
                           self.row_axes(tokens.shape[0])), aux, caches)

    def _dense_stack(self, params: Params, tokens: torch.Tensor,
                     write_kv=None, vision_embeds=None):
        """Embed (behind a vlm's ``vision_embeds``) -> L x dense (or moe)
        block, each layer checkpointed under
        ``remat="full"`` while autograd records, and under ``"group:G"``
        each group of G layers too (when G divides L and no cache is
        written, as in the reference); given ``write_kv``, each layer's
        rotated keys and values go to ``write_kv(i, (k, v))``.  Returns
        the residual stream (B, S, D) in bf16 and the moe layers' aux loss
        summed in layer order (None for dense)."""
        cfg = self.cfg
        rows = self.row_axes(tokens.shape[0])
        x = self._embed(params, tokens, rows, vision_embeds)
        lps = self._unbind_layers(params)
        G = self._group
        if G and write_kv is None and torch.is_grad_enabled():
            aux = None
            for i0 in range(0, cfg.n_layers, G):
                x, aux = checkpoint(self._dense_layers, x, lps[i0:i0 + G],
                                    i0, True, None, rows, aux,
                                    use_reentrant=False)
        else:
            x, aux = self._dense_layers(
                x, lps, 0, self.remat == "full" and torch.is_grad_enabled(),
                write_kv, rows)
        return x, aux

    def _dense_layers(self, x, lps, i0: int, remat: bool, write_kv=None,
                      rows: Tuple[str, ...] = (), aux=None):
        """Layers ``i0 .. i0 + len(lps) - 1`` of the full-sequence
        forward, each checkpointed when ``remat``; given ``write_kv``,
        each layer's keys and values go to ``write_kv(i, (k, v))``.  The
        batch splits over ``rows``, passed to each (re)computed block.
        Returns ``(x, aux)``: the moe layers' aux losses added in layer
        order onto ``aux`` (None for dense layers)."""
        for i, lp in enumerate(lps, start=i0):
            args = (x, lp, self._window(i), write_kv is not None, rows)
            x, a, kv = (checkpoint(self._dense_block, *args,
                                   use_reentrant=False)
                        if remat else self._dense_block(*args))
            if a is not None:
                aux = a if aux is None else aux + a
            if write_kv is not None:
                write_kv(i, kv)
        return x, aux

    def loss_fn(self, params: Params, batch: dict):
        """(mean token loss, metrics ``{loss, aux, tokens}``) of a batch
        ``{"tokens", "labels"}`` (B, S) and a vlm's ``vision_embeds``
        (its labels cover the prefix with -1); labels < 0 are ignored.
        On a mesh the batch is the global one and the first value is this
        rank's rows' share of the mean (:func:`layers.lm_loss_sharded`),
        which the rank differentiates; the metrics hold the global
        mean."""
        cfg = self.cfg
        logits, aux, _ = self.forward(params, batch["tokens"],
                                      batch.get("vision_embeds"))
        if self.mesh is not None:
            rows = self.row_axes(batch["tokens"].shape[0])
            share, loss, denom = layers.lm_loss_sharded(
                logits, batch_block(batch["labels"], self.mesh, rows),
                vocab_real=cfg.vocab_size, mesh=self.mesh,
                tp_axis=self.plan.tp_axis, batch_axes=rows)
            if cfg.family == "moe":
                # the aux term's gradient is split over the ranks by the
                # layers' _AuxMean; its value is every rank's
                share = share + self._aux_term(aux)
                loss = loss + self._aux_term(aux.detach())
            return share, {"loss": loss, "aux": aux.detach(),
                           "tokens": denom}
        loss, denom = layers.lm_loss(logits, batch["labels"],
                                     vocab_real=cfg.vocab_size)
        if cfg.family == "moe":
            loss = loss + self._aux_term(aux)
        return loss, {"loss": loss, "aux": aux, "tokens": denom}

    def _aux_term(self, aux: torch.Tensor) -> torch.Tensor:
        """``router_aux_coef * aux / n_layers``, rounded as the
        reference's (a multiply by the weak-typed coefficient, then the
        division by the layer count as XLA compiles it)."""
        return precision.div_count(self.cfg.router_aux_coef * aux,
                                   self.cfg.n_layers)

    def prefill(self, params: Params, tokens: torch.Tensor,
                vision_embeds=None, last_only: bool = True,
                cache: dict = None, slot: int = 0
                ) -> Tuple[torch.Tensor, dict]:
        """Forward over the prompt ``tokens`` (B, S): fp32 logits (of the
        last position only, by default) and the decode-ready cache: the
        dense family's ``k``/``v`` (L, B, S, Hkv, hd) in bf16; the ssm
        family's ``conv``/``bc_conv`` holding the last W-1 mixer inputs
        and ``ssm`` the fp32 state after the last position.  Given a dense
        ``cache`` (from :meth:`init_cache`), a B = 1 prompt's K/V or
        states are written straight into its row ``slot`` (the dense
        family's at positions 0..S-1; later positions keep what they
        held, which decode never reads) and that cache is returned.

        A windowed config (gemma3) gives its global layers' K/V as
        ``k_g``/``v_g`` and its local layers' rings as ``k_l``/``v_l``
        (W' = min(window, S) slots, slot j holding the last position p =
        j (mod W')), each gathered per layer as it is computed; written
        into a cache, a ring narrower than the cache's is padded with
        zeros at its end, as the reference's one-slot prefill pads it.

        The hybrid gives every layer's states and its sites' ``k``/``v``
        (n_sites, B, S, Hkv, hd); into a cache row, both kinds.  A vlm's
        ``vision_embeds`` lead the prompt (its K/V cover them)."""
        self._servable("prefill")
        if cache is not None and tokens.shape[0] != 1:
            raise ValueError("prefill into a cache row takes one prompt")
        if self.mesh is not None:
            return self._prefill_mesh(params, tokens, last_only, cache, slot)
        if self.cfg.family == "hybrid":
            return self._prefill_hybrid(params, tokens, last_only, cache,
                                        slot)
        if self.cfg.family in ATTENTION_STACKS:
            S = tokens.shape[1]
            ring = (self._ring_positions(S, tokens.device)
                    if self._windowed() else None)
            out: Dict[str, list] = {}

            def write_kv(i, kv):
                suffix, j = self._kv_leaf[i]
                for name, val in zip(("k" + suffix, "v" + suffix), kv):
                    if suffix == "_l":
                        val = val[:, ring]
                    if cache is None:
                        out.setdefault(name, []).append(val)
                        continue
                    n = val.shape[1]
                    cache[name][j, slot, :n].copy_(val[0])
                    if suffix == "_l":
                        cache[name][j, slot, n:].zero_()

            x, _ = self._dense_stack(params, tokens, write_kv,
                                     vision_embeds)
            logits = self._head(params, x[:, -1:] if last_only else x)
            if cache is None:
                cache = {name: torch.stack(vals) for name, vals in out.items()}
            return logits, cache
        if cache is None:
            logits, _, caches = self.forward(
                params, tokens, with_cache=True, last_only=last_only)
            return logits, dict(zip(("conv", "ssm", "bc_conv"), caches))

        def write(i, state):
            for name, val in zip(("conv", "ssm", "bc_conv"), state):
                cache[name][i, slot].copy_(val[0])

        x = self._mixer_stack(params, tokens, write)
        return self._head(params, x[:, -1:] if last_only else x), cache

    def _prefill_hybrid(self, params, tokens, last_only, cache, slot):
        """The hybrid's prefill: every layer's (conv, ssm, bc_conv) state
        (L, B, ...) and the sites' K/V (n_sites, B, S, Hkv, hd), the
        reference's flattened head groups with the tail appended; into
        ``cache`` row ``slot``, the states whole and the K/V at positions
        0..S-1."""
        names = ("conv", "ssm", "bc_conv")
        states, kvs = [], []

        def write_state(i, state):
            if cache is None:
                states.append(state)
                return
            for name, val in zip(names, state):
                cache[name][i, slot].copy_(val[0])

        def write_kv(s, kv):
            if cache is None:
                kvs.append(kv)
                return
            for name, val in zip(("k", "v"), kv):
                cache[name][s, slot, :val.shape[1]].copy_(val[0])

        x = self._hybrid_stack(params, tokens, write_state, write_kv)
        logits = self._head(params, x[:, -1:] if last_only else x)
        if cache is None:
            cache = {name: torch.stack(t)
                     for name, t in zip(names, zip(*states))}
            cache.update({name: torch.stack(t)
                          for name, t in zip(("k", "v"), zip(*kvs))})
        return logits, cache

    def _ring_positions(self, S: int, device) -> torch.Tensor:
        """The prompt position each ring slot holds after a prefill of S
        tokens: slot j of W' = min(window, S) holds the last p = j (mod
        W'), ``clip(S - 1 - ((S - 1 - j) mod W'), 0, S - 1)``."""
        W = min(self.cfg.window, max(S, 1))
        j = torch.arange(W, device=device)
        return torch.clamp(S - 1 - torch.remainder(S - 1 - j, W), 0, S - 1)

    def cache_specs(self, batch: int, seq_len: int) -> Dict[str, ParamSpec]:
        """The dense cache of ``batch`` slots: the dense family's ``k``
        and ``v``, (L, batch, seq_len, Hkv, hd) bf16, on a mesh in the
        plan's ``kv_cache`` layout (a windowed config's
        ``k_g``/``v_g`` for its n_g global layers and ``k_l``/``v_l``
        (n_l, batch, W, Hkv, hd), W = min(window, seq_len), for its local
        layers' rings); the ssm family's states, which do not grow with
        ``seq_len``; the hybrid's states for its L layers and ``k``/``v``
        (n_sites, batch, seq_len, Hkv, hd) for its sites."""
        cfg = self.cfg
        L = cfg.n_layers
        if self._windowed():
            n_g = sum(cfg.is_global_layer(i) for i in range(L))
            W = min(cfg.window, seq_len)
            g = (n_g, batch, seq_len, cfg.n_kv_heads, cfg.d_head)
            loc = (L - n_g, batch, W, cfg.n_kv_heads, cfg.d_head)
            return {"k_g": ParamSpec(g, init="zeros"),
                    "v_g": ParamSpec(g, init="zeros"),
                    "k_l": ParamSpec(loc, init="zeros"),
                    "v_l": ParamSpec(loc, init="zeros")}
        if cfg.family in ATTENTION_STACKS:
            shape = (L, batch, seq_len, cfg.n_kv_heads, cfg.d_head)
            lay = (None if self.mesh is None
                   else self.plan.kv_cache(batch, self.mesh))
            return {"k": ParamSpec(shape, init="zeros", layout=lay),
                    "v": ParamSpec(shape, init="zeros", layout=lay)}
        H, P, N = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        W, di = cfg.conv_width, cfg.d_inner
        GN2 = 2 * cfg.ssm_groups * cfg.ssm_state
        out = {
            "ssm": ParamSpec((L, batch, H, P, N), dtype=torch.float32,
                             init="zeros"),
            "conv": ParamSpec((L, batch, W - 1, di), init="zeros"),
            "bc_conv": ParamSpec((L, batch, W - 1, GN2), init="zeros"),
        }
        if cfg.family == "hybrid":
            shape = (L // cfg.attn_every, batch, seq_len, cfg.n_kv_heads,
                     cfg.d_head)
            out.update(k=ParamSpec(shape, init="zeros"),
                       v=ParamSpec(shape, init="zeros"))
        return out

    def init_cache(self, batch: int, seq_len: int, device=None
                   ) -> Dict[str, torch.Tensor]:
        """The dense cache of ``batch`` slots of ``seq_len`` positions
        (:meth:`cache_specs`); on a mesh this rank's block of it, a
        :class:`MeshCache`."""
        self._servable("init_cache")
        device = self.device if device is None else device
        if self.mesh is None:
            return tree_init(0, self.cache_specs(batch, seq_len), device)
        specs = self.cache_specs(batch, seq_len)
        lay = specs["k"].layout
        rows, seq_axes, offset = self._kv_place(lay, seq_len)
        return MeshCache({name: torch.zeros(
            lay.local_shape(spec.shape, self.mesh), dtype=torch.bfloat16,
            device=device) for name, spec in specs.items()},
            rows=rows, seq_axes=seq_axes, offset=offset)

    def decode_step(self, params: Params, cache: dict, tokens: torch.Tensor,
                    pos: torch.Tensor, *, block_table=None, seq_lens=None
                    ) -> Tuple[torch.Tensor, dict]:
        """One token per slot, ``tokens`` (B, 1), at positions ``pos``
        (scalar or (B,)).  Returns fp32 logits (B, 1, V) and ``cache``,
        updated in place.

        The dense and moe families attend through the paged-decode kernel
        with each slot's cache row as one page (``attention.decode``): its
        (B, 1) ``block_table`` and ``seq_lens = pos + 1`` (int32) are built
        once per step here unless the caller passes them (the engine keeps
        the table across steps).  A windowed config's local layers attend on
        their rings (``attention.decode_ring``) under the same table with
        ``min(seq_lens, W)``, made once per step.  An SSM's step does not
        read ``pos`` (taken for the reference's signature); the hybrid's
        sites attend as the dense family's layers do, on their ``k``/``v``
        under the same table."""
        self._servable("decode_step")
        if self.mesh is not None:
            return self._decode_step_mesh(params, cache, tokens, pos)
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], scale=cfg.emb_scale)
        x = x.to(torch.bfloat16)
        if cfg.family != "ssm":
            B = tokens.shape[0]
            if block_table is None:
                block_table = torch.arange(B, dtype=torch.int32,
                                           device=x.device)[:, None]
            if seq_lens is None:
                seq_lens = (pos.expand(B) + 1).to(torch.int32)
        if cfg.family == "hybrid":
            return self._decode_hybrid(params, cache, x, pos, block_table,
                                       seq_lens)
        if cfg.family in ATTENTION_STACKS:
            ring_lens = (torch.clamp(seq_lens, max=cache["k_l"].shape[2])
                         if "k_l" in cache else None)

            def attend(i, h, p):
                suffix, j = self._kv_leaf[i]
                step = attention.decode_ring if suffix == "_l" \
                    else attention.decode
                return step(
                    h, p, cfg, cache["k" + suffix][j],
                    cache["v" + suffix][j], pos, policy=self.policy,
                    block_table=block_table,
                    seq_lens=ring_lens if suffix == "_l" else seq_lens)[0]

            return self._head(params, self._serve_layers(params, x,
                                                         attend)), cache
        for i in range(cfg.n_layers):
            x = self._decode_mamba(params, cache, x, i)
        return self._head(params, x), cache

    def _decode_mamba(self, params, cache, x, i: int):
        """Mamba layer ``i``'s decode step on the dense cache's states,
        updated in place."""
        cfg = self.cfg
        lp = self._layer(params, i)
        h = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, conv, state, bc = ssm.decode_step(
            h, lp["ssm"], cfg, cache["conv"][i], cache["ssm"][i],
            cache["bc_conv"][i], policy=self.policy)
        cache["conv"][i].copy_(conv)
        cache["ssm"][i].copy_(state)
        cache["bc_conv"][i].copy_(bc)
        return x + y

    def _decode_hybrid(self, params, cache, x, pos, block_table, seq_lens):
        """The hybrid's decode step, in the reference's static groups: each
        site's mamba layers, then the shared block attending on the site's
        ``k``/``v`` through the paged-decode kernel (each slot's row one
        page) and its MLP in ``glu_mlp``'s bf16 product; then the tail."""
        cfg = self.cfg
        sp = self._shared(params)
        every = cfg.attn_every
        n_sites = cfg.n_layers // every
        for s in range(n_sites):
            for i in range(s * every, (s + 1) * every):
                x = self._decode_mamba(params, cache, x, i)
            h = layers.rms_norm(x, sp["ln1"], cfg.norm_eps)
            a, _, _ = attention.decode(
                h, sp["attn"], cfg, cache["k"][s], cache["v"][s], pos,
                policy=self.policy, block_table=block_table,
                seq_lens=seq_lens)
            x = x + a
            h = layers.rms_norm(x, sp["ln2"], cfg.norm_eps)
            w = sp["mlp"]
            x = x + layers.glu_mlp(h, w["gate"], w["in"], w["out"],
                                   act=cfg.act, policy=self.policy)
        for i in range(n_sites * every, cfg.n_layers):
            x = self._decode_mamba(params, cache, x, i)
        return self._head(params, x), cache
