"""The layer stack of every family (counterpart of
``repro.models.stack``).

A Python loop over layers, each a mixer sublayer (attention, or a Mamba2
SSD mixer: ``models.ssm``), on the layers the specs mark a cross-attention
sublayer over ``cross_states`` (its output scaled by ``tanh`` of the
layer's f32 ``cross_gate``, which starts at 0), and a dense or MoE FFN or
none (``ModelConfig.layer_specs``).  The audio encoder is a stack too:
non-causal, its layers' backward taps folded into the class rows
(``indexed_probes=False``).  Parameters load in either of the
reference's layouts: ``{"layers": [per-layer dicts]}`` (unrolled) or
``{"groups": {"l00": ..., "l01": ...}}`` (scan-stacked: one entry per
position of the specs' repeating period, each a dict of tensors with a
leading groups axis; a uniform stack has period 1).  Caches are one dict
per layer, updated in place.  A MoE layer's aux losses
(``moe_load_balance``, ``moe_router_z``, ``moe_frac_dropped``) are summed
over the layers into the ``aux`` dict the caller passes, as the
reference sums them.

With telemetry on, each layer runs in a collection frame
(``telemetry.collect.layer_frame``) and its sublayers in module scopes
(``attn`` or ``ssm``, ``cross``, ``ffn`` or ``moe``); the frame's stats
come out as ``tel/l{i:02d}/...`` in the ``aux`` dict the caller passes.

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

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.core import routing
from repro_torch.core.quantize import split_state, splitting
from repro_torch.core.recipe import LayerRecipe, PrecisionPlan
from repro_torch.kernels.build import recomputing
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.nn.layers import apply_norm, shard_hint
from repro_torch.nn.params import ParamSpec, map_specs
from repro_torch.telemetry import collect as telemetry

__all__ = ["norm_specs", "stack_param_specs", "layer_params", "run_stack",
           "init_stack_cache", "remat", "MOE_AUX"]

# A MoE layer's aux losses, in the order a layer returns them
MOE_AUX = ("moe_load_balance", "moe_router_z", "moe_frac_dropped")


def norm_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    d = {"scale": ParamSpec((cfg.d_model,), ("embed",), init="zeros")}
    if cfg.norm == "layernorm":
        d["bias"] = ParamSpec((cfg.d_model,), ("embed",), init="zeros")
    return d


def _layer_specs(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Any]:
    p = {"mixer_norm": norm_specs(cfg),
         "mixer": (attn_lib.attn_param_specs(cfg) if spec.mixer == "attn"
                   else ssm_lib.mamba_param_specs(cfg))}
    if spec.cross:
        p["cross_norm"] = norm_specs(cfg)
        p["cross"] = attn_lib.cross_attn_param_specs(cfg)
        # learned gate (llama-3.2-vision style): the cross output ramps
        # in from 0
        p["cross_gate"] = ParamSpec((1,), (None,), init="zeros",
                                    dtype=torch.float32)
    if spec.ffn != "none":
        p["ffn_norm"] = norm_specs(cfg)
        p["ffn"] = (moe_lib.moe_param_specs(cfg) if spec.ffn == "moe"
                    else mlp_lib.mlp_param_specs(cfg))
    return p


def stack_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """``{"groups": ...}`` when ``cfg.scan_layers`` (as the reference
    builds it: one stacked entry per position of the period), else
    ``{"layers": [...]}``."""
    specs = cfg.layer_specs()  # rejects the families not ported
    if not cfg.scan_layers:
        return {"layers": [_layer_specs(cfg, s) for s in specs]}
    period = cfg.scan_period()
    n_groups = len(specs) // period

    def bump(s: ParamSpec) -> ParamSpec:
        return ParamSpec((n_groups,) + s.shape, ("layers",) + s.axes,
                         s.init, s.scale, s.dtype)
    return {"groups": {f"l{i:02d}": map_specs(bump,
                                              _layer_specs(cfg, specs[i]))
                       for i in range(period)}}


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]  # a tensor or a stacked PackedTensor


def layer_params(stack_params, i: int):
    """Layer ``i``'s parameters in either layout."""
    if "layers" in stack_params:
        return stack_params["layers"][i]
    groups = stack_params["groups"]
    period = len(groups)
    return _index(groups[f"l{i % period:02d}"], i // period)


def init_stack_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device, per_slot: bool, cross_dtype):
    """One cache a layer, of its mixer's kind: an attention layer's K/V
    and positions (``max_len`` long, or the window's ring), a mamba
    layer's conv history and state (no length); a cross layer's
    ``cross`` K/V besides, (batch, ``n_patches`` (vlm) or ``n_frames``,
    KV heads, head_dim) in ``cross_dtype``: exactly as long as the
    states, not rounded to whole chunks, so that their chunks are the
    reference's ``min(attention_chunk, Skv)``."""
    hd, n_kv = cfg.resolved_head_dim, cfg.n_kv_heads
    n_cross = cfg.n_patches if cfg.family == "vlm" else cfg.n_frames

    def layer(spec: LayerSpec):
        if spec.mixer == "attn":
            c = {"self": attn_lib.init_attn_cache(
                cfg, batch, max_len, dtype, device, per_slot)}
        else:
            c = {"self": ssm_lib.init_mamba_cache(cfg, batch, dtype, device)}
        if spec.cross:
            c["cross"] = {n: torch.zeros((batch, n_cross, n_kv, hd),
                                         dtype=cross_dtype,
                                         device=device)
                          for n in ("k", "v")}
        return c
    return {"layers": [layer(s) for s in cfg.layer_specs()]}


def _run_layer(params, cfg: ModelConfig, spec: LayerSpec, row: LayerRecipe,
               x, *, positions, cross_states, cache, cache_len, decode: bool,
               causal: bool, layer_idx: int, indexed: bool,
               aux: Optional[Dict[str, torch.Tensor]]):
    """``(x, *moe_terms)``: the layer's output, then a MoE layer's aux
    losses in ``MOE_AUX`` order (nothing for a dense layer).  A mamba
    mixer runs the row's ``ffn_linear`` cell, as the reference's; the
    cross sublayer its ``attn_linear`` cell.  ``indexed=False`` opens the
    telemetry frame with no layer index (the backward taps fold into the
    class rows)."""
    terms = ()
    self_cache = None if cache is None else cache["self"]
    with routing.layer_scope(f"L{layer_idx}"), \
            telemetry.layer_frame(layer_idx if indexed else None) \
            as tel_frame:
        h = shard_hint(apply_norm(params["mixer_norm"], x, cfg.norm),
                       ("batch", "seq", "embed"))
        if spec.mixer == "attn":
            with telemetry.module_scope("attn"):
                x = x + attn_lib.attention(
                    params["mixer"], cfg, h, row.attn_linear,
                    positions=positions, cache=self_cache,
                    cache_len=cache_len, causal=causal)
        else:
            with telemetry.module_scope("ssm"):
                x = x + ssm_lib.mamba_mixer(params["mixer"], cfg, h,
                                            row.ffn_linear, cache=self_cache,
                                            decode=decode)
        if spec.cross:
            h = shard_hint(apply_norm(params["cross_norm"], x, cfg.norm),
                           ("batch", "seq", "embed"))
            with telemetry.module_scope("cross"):
                out = attn_lib.cross_attention(
                    params["cross"], cfg, h, row.attn_linear,
                    kv_states=None if decode else cross_states,
                    cache=None if cache is None else cache["cross"])
            gate = torch.tanh(params["cross_gate"].to(torch.float32))
            x = x + (out.to(torch.float32) * gate).to(x.dtype)
        if spec.ffn == "moe":
            h = shard_hint(apply_norm(params["ffn_norm"], x, cfg.norm),
                           ("batch", "seq", "embed"))
            with telemetry.module_scope("moe"):
                out, moe_aux = moe_lib.moe(params["ffn"], cfg, h,
                                           row.ffn_linear)
            x = x + out
            terms = tuple(moe_aux[k] for k in MOE_AUX)
        elif spec.ffn == "dense":
            h = shard_hint(apply_norm(params["ffn_norm"], x, cfg.norm),
                           ("batch", "seq", "embed"))
            with telemetry.module_scope("ffn"):
                x = x + mlp_lib.mlp(params["ffn"], cfg, h, row.ffn_linear)
        x = shard_hint(x, ("batch", "seq", "embed"))
    if tel_frame is not None and aux is not None:
        for k, v in tel_frame.stats.items():
            aux[f"tel/l{layer_idx:02d}/{k}"] = v
    return (x, *terms)


def remat(fn, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``fn(x, aux_ok)`` under ``cfg``'s remat policy: called once with
    ``aux_ok=True`` (the forward), and, when checkpointed, again in the
    backward with ``aux_ok=False``, its launches counted as recompute, its
    taps replaying the forward's telemetry state and its matmuls recording
    into the forward's routing census.  ``fn`` returns a tensor or a
    tuple of tensors (a MoE layer's output and aux losses: the recompute
    routes the same tokens to the same experts, the inputs being equal)."""
    if not cfg.remat or cfg.remat_policy == "none" or \
            not torch.is_grad_enabled():
        return fn(x, True)
    if cfg.remat_policy == "dots":
        raise NotImplementedError(
            "remat_policy='dots' keeps the matmul outputs: no selective-"
            "checkpoint policy sees the port's quantized matmul kernels")
    if cfg.remat_policy != "full":
        raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}")
    tel, census, split = (telemetry.snapshot(), routing.active(),
                          split_state())
    calls = []

    def run(x_):
        if not calls:
            calls.append(1)
            return fn(x_, True)
        # the recompute may run on autograd's thread: the forward's token
        # and model splits go with it, so it quantizes as the forward did
        with recomputing(), telemetry.replaying(tel), \
                routing.replaying(census), splitting(*split):
            return fn(x_, False)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def run_stack(params, cfg: ModelConfig, plan: PrecisionPlan,
              x: torch.Tensor, *, positions: torch.Tensor,
              cross_states: Optional[torch.Tensor] = None,
              cache: Optional[Dict[str, List]] = None,
              cache_len: Optional[torch.Tensor] = None,
              decode: bool = False, causal: bool = True,
              indexed_probes: bool = True,
              aux: Optional[Dict[str, torch.Tensor]] = None
              ) -> torch.Tensor:
    """All layers, each under its plan row; caches update in place
    (``decode``: a one-token step, which a mamba mixer takes from its
    state and a cross sublayer from its cached K/V; otherwise a cross
    sublayer projects ``cross_states``);
    per-layer telemetry stats and the MoE aux losses (summed over the
    layers, in layer order) go into ``aux`` when given.
    ``indexed_probes=False`` (the audio encoder) folds the layers'
    backward taps into the class rows, so that they do not land in the
    decoder's rows of the same index."""
    if plan.n_layers != cfg.n_layers:
        raise ValueError(f"plan has {plan.n_layers} layers, model "
                         f"{cfg.n_layers}")
    specs = cfg.layer_specs()
    moe_total: Dict[str, torch.Tensor] = {}
    for i in range(cfg.n_layers):
        def layer(x_, aux_ok, i=i):
            return _run_layer(
                layer_params(params, i), cfg, specs[i], plan.layers[i], x_,
                positions=positions, cross_states=cross_states,
                cache=None if cache is None else cache["layers"][i],
                cache_len=cache_len, decode=decode, causal=causal,
                layer_idx=i, indexed=indexed_probes,
                aux=aux if aux_ok else None)
        out = layer(x, True) if cache is not None else remat(layer, x, cfg)
        x = out[0]
        for key, v in zip(MOE_AUX, out[1:]):
            moe_total[key] = v if key not in moe_total else \
                moe_total[key] + v
    if aux is not None:
        aux.update(moe_total)
    return x
