"""Layer math: linears, activations, norms, RoPE, and the activation
sharding hints (counterpart of ``repro.nn.layers``)."""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional, Sequence

import numpy as np
import torch
from torch.nn.functional import pad as F_pad

from repro_torch import constant
from repro_torch.core.qlinear import model_stat_sum, qlinear
from repro_torch.core.quantize import ModelSplit, TokenSplit, splitting
from repro_torch.core.recipe import MatmulRecipe

__all__ = ["linear", "gelu", "silu", "relu2", "rms_norm", "layer_norm",
           "apply_norm", "rope", "sincos_positions", "ACTIVATIONS",
           "set_sharding_context", "get_sharding_context",
           "sharding_context", "shard_hint"]


def linear(x: torch.Tensor, w, recipe: MatmulRecipe, cfg, *,
           bias: Optional[torch.Tensor] = None,
           tp: Optional[str] = None) -> torch.Tensor:
    """Quantized linear with the implementation ``cfg.linear_impl``;
    ``tp``: ``w`` is the rank's block of a column- or row-parallel weight
    (``core.qlinear``)."""
    return qlinear(x, w, recipe, bias=bias, impl=cfg.linear_impl, tp=tp)


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


def relu2(x):
    """Squared ReLU (nemotron-4), ``relu(x) * relu(x)`` in ``x``'s dtype."""
    r = torch.relu(x)
    return r * r


ACTIVATIONS = {"gelu": gelu, "silu": silu, "relu2": relu2}


# On the card PyTorch picks a reduction's launch shape by its number of
# outputs, so the mean of one row among 8 can differ in its last bits from
# the same row's mean alone: a decode step of 8 slots then left sequential
# generation (mamba2's norms, chip_smoke's serve_ssm at 8 requests).  A
# CUDA tensor of at most ROW_INVARIANT_ROWS rows (a decode step: one row a
# slot) is padded with zero rows to that count before its mean, so every
# such call reduces at one launch shape and a row's mean is its own, as
# the MoE router pads its rows (``models.moe.ROUTER_ROWS``); more rows
# (prefill, training) and CPU tensors reduce as they are.
ROW_INVARIANT_ROWS = 16


def _row_mean(fn, xf: torch.Tensor) -> torch.Tensor:
    """The mean over the last dim of ``fn(xf)`` (elementwise, ``fn(0) =
    0``), keepdim; at the padded shape under the rule above."""
    rows = xf.numel() // max(xf.shape[-1], 1)
    if not (xf.is_cuda and rows <= ROW_INVARIANT_ROWS):
        return fn(xf).mean(dim=-1, keepdim=True)
    padded = F_pad(xf.reshape(rows, xf.shape[-1]),
                   (0, 0, 0, ROW_INVARIANT_ROWS - rows))
    return fn(padded).mean(dim=-1, keepdim=True)[:rows].reshape(
        *xf.shape[:-1], 1)


def rms_norm(x, scale, eps=1e-5, width: Optional[int] = None):
    """RMS norm over the last dim.  ``width``: ``x`` holds this rank's
    columns of rows ``width`` wide, split over the installed model group
    (``scale`` its block): the mean of squares is the group's sum of the
    ranks' partial sums over ``width``, summed both ways
    (``core.qlinear.model_stat_sum``: the statistic's cotangent on a rank
    covers its own columns alone)."""
    xf = x.to(torch.float32)
    if width is None or width == x.shape[-1]:
        var = _row_mean(lambda t: t * t, xf)
    else:
        var = model_stat_sum((xf * xf).sum(dim=-1, keepdim=True)) / width
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(torch.float32))).to(x.dtype)


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.to(torch.float32)
    mu = _row_mean(lambda t: t, xf)
    var = _row_mean(lambda t: t, (xf - mu) ** 2)
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


@functools.lru_cache(maxsize=8)
def sincos_positions(seq_len: int, dim: int, device=None) -> torch.Tensor:
    """Fixed sinusoidal position embeddings (the whisper encoder), (seq_len,
    dim) f32: computed in numpy f32 as the reference computes them
    (``torch.sin`` can land an ulp away), then made a tensor on
    ``device``, once per arguments and shared (a CUDA graph cannot capture
    the copy; callers must not write to it)."""
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    i = np.arange(dim // 2, dtype=np.float32)[None, :]
    ang = pos / (10000.0 ** (2 * i / dim))
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(emb).to(device)


# ---------------------------------------------------------------------------
# Activation sharding hints.
#
# Model code calls ``shard_hint(x, ('batch', 'seq', 'embed'))``; a step
# installs a context (a ``distributed.sharding.ShardingRules``) mapping
# logical activation axes to mesh axes.  Without a context this is a
# no-op, as the reference's.  The port holds each rank's own block of a
# data-parallel step, so a hint that maps only to axes of size 1 (the
# data axes are stripped by the step's ``manual_over``) is a no-op too;
# a hint that would shard over a larger data axis raises.  Under tensor
# parallelism the model code already holds the rank's slice of every
# heads / mlp activation (its weights are the rank's blocks), or the
# whole tensor where the port keeps it whole (the gathered vocab), and
# the MoE sublayer holds its own experts (or its block of each expert's
# ``mlp``), and the mamba mixer its whole SSD heads: a hint over the model
# axis is a no-op.
#
# The data-manual region of a data-parallel step that reduces the mean
# gradient (``train.train_step``'s ``reduce_mean`` and the eval step) also
# carries the token split (``core.quantize.TokenSplit``: the data group
# and this rank's index there, whence its row offset): quant groups that
# span the tokens share their amax across the group inside it.  The fp8
# compressed step's region carries none: the reference's per-shard slices
# quantize on their own there.
# ---------------------------------------------------------------------------

_CTX = threading.local()


def set_sharding_context(ctx) -> None:
    """Install a sharding context (a ``ShardingRules``; None: none)."""
    _CTX.value = ctx


def get_sharding_context():
    return getattr(_CTX, "value", None)


@contextlib.contextmanager
def sharding_context(ctx, split: Optional[TokenSplit] = None,
                     model: Optional[ModelSplit] = None):
    """Install ``ctx`` (and the token ``split`` and the ``model`` split,
    None: none) inside the block."""
    prev = get_sharding_context()
    set_sharding_context(ctx)
    try:
        with splitting(split, model):
            yield
    finally:
        set_sharding_context(prev)


def shard_hint(x: torch.Tensor,
               axes: Sequence[Optional[str]]) -> torch.Tensor:
    """``x`` itself; raises ``NotImplementedError`` when the context would
    shard it over a data axis larger than 1 (outside a data-manual
    region)."""
    ctx = get_sharding_context()
    if ctx is None:
        return x
    sharding = ctx.activation_sharding(tuple(axes), x.shape)
    for dim, names in sharding.dim_axes().items():
        if ctx.axis_size(names) <= 1:
            continue
        if names != ("model",):
            raise NotImplementedError(
                f"shard_hint{tuple(axes)}: dim {dim} would shard over mesh "
                f"axes {names} (size {ctx.axis_size(names)}); the port "
                "runs data parallelism over rank-local slices (run under "
                "rules.manual_over(rules.dp_axes))")
    return x
