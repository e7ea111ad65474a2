"""The decoder-layer stack, dense family (counterpart of
``repro.models.stack``).

A Python loop over layers.  Parameters load in either of the reference's
layouts: ``{"layers": [per-layer dicts]}`` (unrolled) or
``{"groups": {"l00": dict of tensors with a leading layers axis}}``
(scan-stacked; the dense family repeats with period 1).  Caches are one
dict per layer, updated in place.

With telemetry on, each layer runs in a collection frame
(``telemetry.collect.layer_frame``) and its sublayers in module scopes
(``attn``, ``ffn``); the frame's stats come out as ``tel/l{i:02d}/...``
in the ``aux`` dict the caller passes.

Remat (``ModelConfig.remat``, the counterpart of the reference's
``_checkpoint``): under ``remat_policy="full"`` a training forward keeps
only each layer's input and re-runs the layer in the backward
(``torch.utils.checkpoint``, non-reentrant).  The re-run computes the
same numbers with the same kernels; its kernel launches count apart
(``kernels.build.recomputing``) and its telemetry taps run under a
throwaway collector (``telemetry.collect.replaying``), so no stat is
recorded twice.  ``"dots"`` (keep the matmul outputs) needs a
selective-checkpoint policy that sees the quantized matmuls, and they
are ctypes launches inside autograd Functions that no such policy sees:
it raises.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import routing
from repro_torch.core.recipe import LayerRecipe, PrecisionPlan
from repro_torch.kernels.build import recomputing
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.nn.layers import apply_norm
from repro_torch.nn.params import ParamSpec, map_specs
from repro_torch.telemetry import collect as telemetry

__all__ = ["norm_specs", "stack_param_specs", "layer_params", "run_stack",
           "init_stack_cache", "remat"]


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
               positions, cache, cache_len, layer_idx: int,
               aux: Optional[Dict[str, torch.Tensor]]):
    with routing.layer_scope(f"L{layer_idx}"), \
            telemetry.layer_frame(layer_idx) as tel_frame:
        h = apply_norm(params["mixer_norm"], x, cfg.norm)
        with telemetry.module_scope("attn"):
            x = x + attn_lib.attention(
                params["mixer"], cfg, h, row.attn_linear,
                positions=positions,
                cache=None if cache is None else cache["self"],
                cache_len=cache_len)
        h = apply_norm(params["ffn_norm"], x, cfg.norm)
        with telemetry.module_scope("ffn"):
            x = x + mlp_lib.mlp(params["ffn"], cfg, h, row.ffn_linear)
    if tel_frame is not None and aux is not None:
        for k, v in tel_frame.stats.items():
            aux[f"tel/l{layer_idx:02d}/{k}"] = v
    return x


def remat(fn, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``fn(x, aux_ok)`` under ``cfg``'s remat policy: called once with
    ``aux_ok=True`` (the forward), and, when checkpointed, again in the
    backward with ``aux_ok=False``, its launches counted as recompute, its
    taps replaying the forward's telemetry state and its matmuls recording
    into the forward's routing census."""
    if not cfg.remat or cfg.remat_policy == "none" or \
            not torch.is_grad_enabled():
        return fn(x, True)
    if cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' keeps the matmul outputs: no selective-"
            "checkpoint policy sees the port's quantized matmul kernels")
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    tel, census = telemetry.snapshot(), routing.active()
    calls = []

    def run(x_):
        if not calls:
            calls.append(1)
            return fn(x_, True)
        with recomputing(), telemetry.replaying(tel), \
                routing.replaying(census):
            return fn(x_, False)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def run_stack(params, cfg: ModelConfig, plan: PrecisionPlan,
              x: torch.Tensor, *, positions: torch.Tensor,
              cache: Optional[Dict[str, List]] = None,
              cache_len: Optional[torch.Tensor] = None,
              aux: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
    """All layers, each under its plan row; caches update in place;
    per-layer telemetry stats go into ``aux`` when given."""
    if plan.n_layers != cfg.n_layers:
        raise ValueError(f"plan has {plan.n_layers} layers, model "
                         f"{cfg.n_layers}")
    for i in range(cfg.n_layers):
        def layer(x_, aux_ok, i=i):
            return _run_layer(
                layer_params(params, i), cfg, plan.layers[i], x_,
                positions=positions,
                cache=None if cache is None else cache["layers"][i],
                cache_len=cache_len, layer_idx=i,
                aux=aux if aux_ok else None)
        x = layer(x, True) if cache is not None else remat(layer, x, cfg)
    return x
