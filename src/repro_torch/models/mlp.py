"""Dense FFN sublayer — the paper's FP4 target (counterpart of
``repro.models.mlp``)."""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.recipe import MatmulRecipe
from repro_torch.nn.layers import ACTIVATIONS, linear, shard_hint
from repro_torch.nn.params import ParamSpec

__all__ = ["mlp_param_specs", "mlp"]


def mlp_param_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d, f = cfg.d_model, cfg.d_ff
    down_scale = 1.0 / math.sqrt(f * max(cfg.n_layers, 1))
    specs = {"w_up": ParamSpec((d, f), ("embed", "mlp")),
             "w_down": ParamSpec((f, d), ("mlp", "embed"),
                                 scale=down_scale)}
    if cfg.activation == "swiglu":
        specs = {"w_gate": ParamSpec((d, f), ("embed", "mlp")), **specs}
    return specs


def mlp(params, cfg: ModelConfig, x: torch.Tensor,
        recipe: MatmulRecipe) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D); gelu or swiglu, matmuls per ``recipe``,
    the nonlinearity in the compute dtype.  Under tensor parallelism the
    weights are the rank's blocks of ``d_ff`` (the Megatron layout): up
    and gate column-parallel, down row-parallel (its output summed over
    the model group)."""
    split = params["w_up"].shape[-1] != cfg.d_ff
    col, row = ("col", "row") if split else (None, None)
    if cfg.activation == "swiglu":
        g = linear(x, params["w_gate"], recipe, cfg, tp=col)
        u = linear(x, params["w_up"], recipe, cfg, tp=col)
        h = ACTIVATIONS["silu"](g) * u
    else:
        h = ACTIVATIONS[cfg.activation](
            linear(x, params["w_up"], recipe, cfg, tp=col))
    h = shard_hint(h, ("batch", "seq", "mlp"))
    return linear(h, params["w_down"], recipe, cfg, tp=row)
