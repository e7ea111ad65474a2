"""Layer math: linears, activations, norms, RoPE (counterpart of
``repro.nn.layers``)."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch import constant
from repro_torch.core.qlinear import qlinear
from repro_torch.core.recipe import MatmulRecipe

__all__ = ["linear", "gelu", "silu", "rms_norm", "layer_norm",
           "apply_norm", "rope", "ACTIVATIONS"]


def linear(x: torch.Tensor, w, recipe: MatmulRecipe, cfg, *,
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantized linear with the implementation ``cfg.linear_impl``."""
    return qlinear(x, w, recipe, bias=bias, impl=cfg.linear_impl)


def gelu(x):
    """GELU, tanh form, as the reference's ``jax.nn.gelu(approximate=True)``
    computes it: one op at a time, constants and every intermediate in
    ``x``'s dtype (so bf16 matches the reference bit for bit, where one
    fused rounding would not)."""
    def const(v):
        return constant(v, x.dtype, x.device)
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def silu(x):
    """``x * (1 / (1 + exp(-x)))`` one op at a time in ``x``'s dtype, as
    the reference's ``jax.nn.silu`` computes it."""
    return x * (1 / (1 + torch.exp(-x)))


ACTIVATIONS = {"gelu": gelu, "silu": silu}


def rms_norm(x, scale, eps=1e-5):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * (1.0 + scale.to(torch.float32)) + bias.to(torch.float32)
    return y.to(x.dtype)


def apply_norm(params: dict, x, kind: str):
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"])
    if kind == "layernorm":
        return layer_norm(x, params["scale"], params["bias"])
    raise ValueError(kind)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding.  x: (..., seq, heads, head_dim); positions (seq,)
    or (batch, seq).  Frequencies are computed in numpy f32 exactly as
    the reference does."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    freqs = constant(tuple(np.asarray(freqs, np.float32).tolist()),
                     torch.float32, x.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    if positions.dim() == 1:
        cos, sin = cos[None], sin[None]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
