"""The decoder-layer stack, dense family (counterpart of
``repro.models.stack``).

A Python loop over layers.  Parameters load in either of the reference's
layouts: ``{"layers": [per-layer dicts]}`` (unrolled) or
``{"groups": {"l00": dict of tensors with a leading layers axis}}``
(scan-stacked; the dense family repeats with period 1).  Caches are one
dict per layer, updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.recipe import LayerRecipe, PrecisionPlan
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.nn.layers import apply_norm
from repro_torch.nn.params import ParamSpec, map_specs

__all__ = ["norm_specs", "stack_param_specs", "layer_params", "run_stack",
           "init_stack_cache"]


def norm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = {"scale": ParamSpec((cfg.d_model,), ("embed",), init="zeros")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamSpec((cfg.d_model,), ("embed",), init="zeros")
    return d


def _layer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"mixer_norm": norm_specs(cfg),
            "mixer": attn_lib.attn_param_specs(cfg),
            "ffn_norm": norm_specs(cfg),
            "ffn": mlp_lib.mlp_param_specs(cfg)}


def stack_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """``{"groups": ...}`` when ``cfg.scan_layers`` (as the reference
    builds it), else ``{"layers": [...]}``."""
    cfg.layer_specs()  # rejects non-dense families
    if not cfg.scan_layers:
        return {"layers": [_layer_specs(cfg) for _ in range(cfg.n_layers)]}

    def bump(s: ParamSpec) -> ParamSpec:
        return ParamSpec((cfg.n_layers,) + s.shape, ("layers",) + s.axes,
                         s.init, s.scale, s.dtype)
    return {"groups": {"l00": map_specs(bump, _layer_specs(cfg))}}


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]  # a tensor or a stacked PackedTensor


def layer_params(stack_params, i: int):
    """Layer ``i``'s parameters in either layout."""
    if "layers" in stack_params:
        return stack_params["layers"][i]
    return _index(stack_params["groups"]["l00"], i)


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device, per_slot: bool = False):
    return {"layers": [
        {"self": attn_lib.init_attn_cache(cfg, batch, max_len, dtype,
                                          device, per_slot)}
        for _ in range(cfg.n_layers)]}


def _run_layer(params, cfg: ModelConfig, row: LayerRecipe, x, *,
               positions, cache, cache_len):
    h = apply_norm(params["mixer_norm"], x, cfg.norm)
    x = x + attn_lib.attention(
        params["mixer"], cfg, h, row.attn_linear, positions=positions,
        cache=None if cache is None else cache["self"],
        cache_len=cache_len)
    h = apply_norm(params["ffn_norm"], x, cfg.norm)
    return x + mlp_lib.mlp(params["ffn"], cfg, h, row.ffn_linear)


def run_stack(params, cfg: ModelConfig, plan: PrecisionPlan,
              x: torch.Tensor, *, positions: torch.Tensor,
              cache: Optional[Dict[str, List]] = None,
              cache_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All layers, each under its plan row; caches update in place."""
    if plan.n_layers != cfg.n_layers:
        raise ValueError(f"plan has {plan.n_layers} layers, model "
                         f"{cfg.n_layers}")
    for i in range(cfg.n_layers):
        x = _run_layer(layer_params(params, i), cfg, plan.layers[i], x,
                       positions=positions,
                       cache=None if cache is None else cache["layers"][i],
                       cache_len=cache_len)
    return x
