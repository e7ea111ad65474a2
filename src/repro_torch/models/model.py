"""Model API for the dense family: init, forward, prefill, decode_step
(counterpart of ``repro.models.model``).

Parameters are a nested dict mirroring the reference's tree; precision
enters through the ``plan`` argument (a ``PrecisionPlan``, or a
``PrecisionRecipe`` coerced to the uniform plan).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.core.packed import PackedTensor
from repro_torch.core.recipe import PrecisionPlan, as_plan
from repro_torch.models import stack as stack_lib
from repro_torch.nn.layers import apply_norm, linear
from repro_torch.nn.params import ParamSpec, init_params

__all__ = ["Model", "build_model", "tree_map"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def tree_map(fn, tree):
    """Apply ``fn`` to every tensor / PackedTensor leaf of a nested
    dict / list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


class Model:
    """Dense decoder LM on one device (``cuda`` unless ``device`` says
    otherwise)."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = _DTYPES[cfg.dtype]

    # -- parameters ----------------------------------------------------

    def param_specs(self) -> Dict[str, Any]:
        cfg = self.cfg
        d = cfg.d_model
        specs: Dict[str, Any] = {
            "embed": ParamSpec((cfg.vocab_size, d), ("vocab", "embed"),
                               init="embed"),
            "final_norm": stack_lib.norm_specs(cfg),
            "stack": stack_lib.stack_param_specs(cfg),
        }
        if cfg.pos_emb == "learned":
            specs["pos_embed"] = ParamSpec((cfg.max_seq_len, d),
                                           (None, "embed"), init="embed")
        if not cfg.tie_embeddings:
            specs["head"] = ParamSpec((d, cfg.vocab_size),
                                      ("embed", "vocab"),
                                      scale=1.0 / math.sqrt(d))
        return specs

    def init(self, seed: int = 0, dtype=torch.float32):
        """Seeded init (truncated normal, fan-in scaled), f32 master
        weights on the model's device."""
        return init_params(self.param_specs(), seed, dtype, self.device)

    def cast_params(self, params):
        """Floating tensors to the compute dtype; PackedTensor leaves pass
        through (they expand at their matmul).  A tensor already in the
        compute dtype is returned as is, so casting once up front makes
        later calls free."""
        def cast(p):
            if isinstance(p, PackedTensor) or not p.is_floating_point():
                return p
            return p.to(self.dtype)
        return tree_map(cast, params)

    # -- embedding / head ------------------------------------------------

    def _embed(self, params, tokens, positions):
        x = params["embed"][tokens].to(self.dtype)
        if self.cfg.pos_emb == "learned":
            pe = params["pos_embed"][positions].to(self.dtype)
            x = x + (pe if positions.dim() == tokens.dim() else pe[None])
        return x

    def _head(self, params, x, plan: PrecisionPlan):
        x = apply_norm(params["final_norm"], x, self.cfg.norm)
        w = (params["embed"].to(self.dtype).T if self.cfg.tie_embeddings
             else params["head"].to(self.dtype))
        return linear(x, w, plan.head_linear, self.cfg)

    def _plan(self, p) -> PrecisionPlan:
        return as_plan(p, self.cfg.n_layers)

    # -- forward (no cache) ---------------------------------------------

    @torch.no_grad()
    def forward(self, params, tokens: torch.Tensor, plan) -> torch.Tensor:
        """Logits of every position, (B, S, V) — teacher forcing."""
        plan = self._plan(plan)
        params = self.cast_params(params)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x = self._embed(params, tokens, positions)
        x = stack_lib.run_stack(params["stack"], self.cfg, plan, x,
                                positions=positions)
        return self._head(params, x, plan)

    # -- serving ---------------------------------------------------------

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16,
                   per_slot: bool = False):
        """KV cache; ``per_slot`` gives every row its own length
        (``length`` (batch,)) and position track."""
        return {
            "stack": stack_lib.init_stack_cache(self.cfg, batch, max_len,
                                                dtype, self.device,
                                                per_slot),
            "length": torch.zeros((batch,) if per_slot else (),
                                  dtype=torch.int32, device=self.device),
        }

    @torch.no_grad()
    def prefill(self, params, tokens: torch.Tensor, cache, plan, *,
                true_length: Optional[int] = None
                ) -> Tuple[torch.Tensor, Any]:
        """Process a prompt into ``cache`` (updated in place); returns
        (last-position logits (B, 1, V), cache).  With ``true_length`` the
        prompt is right-padded: logits come from position
        ``true_length - 1`` and the length advances by ``true_length``;
        the padded tail's K/V sit at positions >= that length, masked for
        every later query until decode overwrites them."""
        plan = self._plan(plan)
        params = self.cast_params(params)
        sq = tokens.shape[1]
        length = cache["length"]
        ar = torch.arange(sq, dtype=torch.int32, device=tokens.device)
        positions = (length[:, None] + ar[None] if length.dim()
                     else length + ar)
        x = self._embed(params, tokens, positions)
        x = stack_lib.run_stack(params["stack"], self.cfg, plan, x,
                                positions=positions, cache=cache["stack"],
                                cache_len=length)
        if true_length is None:
            x_last, advance = x[:, -1:], sq
        else:
            x_last, advance = x[:, true_length - 1:true_length], true_length
        logits = self._head(params, x_last, plan)
        cache["length"] = length + advance
        return logits, cache

    @torch.no_grad()
    def decode_step(self, params, token: torch.Tensor, cache, plan
                    ) -> Tuple[torch.Tensor, Any]:
        """One decode step: token (B, 1) -> logits (B, 1, V).  A per-slot
        cache decodes every row at its own position."""
        plan = self._plan(plan)
        params = self.cast_params(params)
        pos = cache["length"]
        positions = (pos[:, None] if pos.dim() else pos[None]).to(
            torch.int32)
        x = self._embed(params, token, positions)
        x = stack_lib.run_stack(params["stack"], self.cfg, plan, x,
                                positions=positions, cache=cache["stack"],
                                cache_len=pos)
        logits = self._head(params, x, plan)
        cache["length"] = pos + 1
        return logits, cache


def build_model(cfg: ModelConfig, device=None) -> Model:
    return Model(cfg, device)
