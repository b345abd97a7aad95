"""The dense decoder LM on the paged serve path, ported from the
reference's ``models/transformer.py``.

The reference scans one jitted layer body over the stacked params; PyTorch
runs eagerly, so here a Python loop walks the ``L`` layers, indexing the
stacked ``(L, ...)`` params and KV pages of each.  Parameters are passed
explicitly, as in the reference, so both packages' steps take the same
arguments.  Training (``forward``, ``loss_fn``) and the dense-cache
``prefill``/``decode_step`` come with later slices.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch
from torch import nn

from repro_torch.core import precision
from repro_torch.core.device import resolve_device
from repro_torch.models import attention, layers
from repro_torch.models.params import ParamSpec, tree_init

Params = Dict[str, torch.Tensor]


class Model(nn.Module):
    """Dense-family decoder (embed -> L x [RMSNorm -> rotary GQA attention
    -> RMSNorm -> gated MLP] -> RMSNorm -> unembed) on ``device``, which
    defaults to the card; ``device="cpu"`` runs the plain versions of the
    kernels."""

    def __init__(self, cfg, *, device: Union[str, torch.device] = "cuda",
                 policy: precision.Policy = precision.MIXED):
        super().__init__()
        if cfg.family != "dense" or cfg.qk_norm:
            raise NotImplementedError(
                f"{cfg.name}: only the dense family without qk-norm is "
                "ported so far")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = policy

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def param_specs(self) -> Dict[str, ParamSpec]:
        cfg = self.cfg
        D, V, F, L = cfg.d_model, cfg.padded_vocab, cfg.d_ff, cfg.n_layers
        out_scale = 0.02 / max(1, 2 * L) ** 0.5
        layer = {
            "ln1": ParamSpec((D,), init="ones"),
            "ln2": ParamSpec((D,), init="ones"),
            **{f"attn.{k}": s for k, s in attention.attn_specs(cfg).items()},
            "mlp.gate": ParamSpec((D, F)),
            "mlp.in": ParamSpec((D, F)),
            "mlp.out": ParamSpec((F, D), init="scaled", scale=out_scale),
        }
        return {
            "embed": ParamSpec((V, D)),
            "unembed": ParamSpec((D, V)),
            "final_norm": ParamSpec((D,), init="ones"),
            **{f"layers.{k}": s.stacked(L) for k, s in layer.items()},
        }

    def init(self, seed: int) -> Params:
        """Random weights from ``seed`` on the model's device."""
        return tree_init(seed, self.param_specs(), self.device)

    @staticmethod
    def _layer(params: Params, i: int) -> dict:
        """Layer ``i``'s params as the nested dict the blocks take."""
        lp: dict = {"attn": {}, "mlp": {}}
        for name, val in params.items():
            if name.startswith("layers."):
                parts = name.split(".")[1:]
                if len(parts) == 1:
                    lp[parts[0]] = val[i]
                else:
                    lp[parts[0]][parts[1]] = val[i]
        return lp

    def _mlp(self, h, lp):
        return layers.glu_mlp(h, lp["mlp"]["gate"], lp["mlp"]["in"],
                              lp["mlp"]["out"], act=self.cfg.act,
                              policy=self.policy)

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        x = layers.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return layers.unembed(x, params["unembed"], policy=self.policy)

    # ------------------------------------------------------------------
    # block-paged KV cache
    # ------------------------------------------------------------------
    def paged_supported(self) -> bool:
        """Paged decode covers uniform full-attention layers: no sliding
        windows, no logit softcap."""
        cfg = self.cfg
        return cfg.window is None and cfg.attn_softcap is None

    def _pages(self, num_pages: int, page_size: int
               ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        if not self.paged_supported():
            raise ValueError(f"paged decode unsupported for window="
                             f"{cfg.window} softcap={cfg.attn_softcap}")
        shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
                 cfg.d_head)
        return {"k_pages": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=self.device),
                "v_pages": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=self.device)}

    def init_paged_cache(self, batch: int, seq_len: int,
                         page_size: int = 64) -> Dict[str, torch.Tensor]:
        """Page pool plus a slot-major table: slot b owns pages
        ``[b*nb, (b+1)*nb)``, ``nb = ceil(seq_len / page_size)``."""
        nb = -(-seq_len // page_size)
        cache = self._pages(batch * nb, page_size)
        cache["table"] = torch.arange(
            batch * nb, dtype=torch.int32, device=self.device
        ).reshape(batch, nb)
        return cache

    def init_paged_pool(self, num_pages: int, page_size: int = 64
                        ) -> Dict[str, torch.Tensor]:
        """Bare page pool for a continuous-batching allocator; page 0 is
        the NULL page that idle slots and unallocated table tails use."""
        return self._pages(num_pages, page_size)

    def prefill_chunk_paged(self, params: Params, cache: dict,
                            tokens: torch.Tensor, table_row: torch.Tensor,
                            start: int) -> Tuple[torch.Tensor, dict]:
        """One end-padded prefill chunk ``tokens`` (1, C) for ONE sequence
        whose logical->physical row is ``table_row``, ``start`` being the
        absolute position of ``tokens[0, 0]``.  Returns fp32 logits
        (1, C, V) and ``cache``, whose pages were updated in place."""
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], scale=cfg.emb_scale)
        x = x.to(torch.bfloat16)
        for i in range(cfg.n_layers):
            lp = self._layer(params, i)
            h = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
            a, _, _ = attention.prefill_chunk_paged(
                h, lp["attn"], cfg, cache["k_pages"][i], cache["v_pages"][i],
                table_row, start, policy=self.policy)
            x = x + a
            h = layers.rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + self._mlp(h, lp)
        return self._head(params, x), cache

    def decode_step_paged(self, params: Params, cache: dict,
                          tokens: torch.Tensor, pos: torch.Tensor
                          ) -> Tuple[torch.Tensor, dict]:
        """One token per slot, ``tokens`` (B, 1) at positions ``pos``
        (scalar or (B,)), against ``cache["table"]``.  Returns fp32 logits
        (B, 1, V) and ``cache``, whose pages were updated in place."""
        cfg = self.cfg
        x = layers.embed(tokens, params["embed"], scale=cfg.emb_scale)
        x = x.to(torch.bfloat16)
        for i in range(cfg.n_layers):
            lp = self._layer(params, i)
            h = layers.rms_norm(x, lp["ln1"], cfg.norm_eps)
            a, _, _ = attention.decode_paged(
                h, lp["attn"], cfg, cache["k_pages"][i], cache["v_pages"][i],
                cache["table"], pos, policy=self.policy)
            x = x + a
            h = layers.rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + self._mlp(h, lp)
        return self._head(params, x), cache
