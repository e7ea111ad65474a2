"""The shared bit-exact rounding codec (counterpart of
``repro.kernels.rounding``): the plain PyTorch form of what
``kernels/csrc/codec.cuh`` computes on the card.

``round_to_grid`` takes the binade exponent from the f32 bit pattern and
assembles the grid step by writing the exponent field back, so every
intermediate is exact.  ``quantize_tile`` is the group QDQ in the
reference's dtype order: amax in the input dtype, scale in f32 (true
division, eps floor), cast to the input dtype, divide, round, rescale in
the input dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["round_to_grid", "pow2_floor", "group_scale", "quantize_tile",
           "snap_to_dtype"]

_F32_MANT = 23
_F32_BIAS = 127


def snap_to_dtype(t: torch.Tensor) -> torch.Tensor:
    """Identity in PyTorch: every tensor op rounds its result into the
    tensor's dtype, so no value is carried wider than bf16.  Kept so the
    reference's call sites read the same here."""
    return t


def round_to_grid(t: torch.Tensor, fmt,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Round pre-scaled values onto ``fmt``'s grid, bit-exact.

    RTN half-to-even (``torch.round``), clip to ``fmt.max_value``, fixed
    subnormal grid ``2^(emin - mbits)``.  The sign is carried with
    ``copysign`` so ``-0.0`` stays ``-0.0`` as in the reference's
    ``sign(x) * q * step``.  ``noise`` (uniform [0, 1), f32) switches to
    stochastic rounding ``floor(t/step + u) * step``.
    """
    orig_dtype = t.dtype
    xf = t.to(torch.float32)
    mag = torch.clamp(xf.abs(), max=fmt.max_value)
    bits = mag.view(torch.int32)
    e = torch.clamp((bits >> _F32_MANT) - _F32_BIAS, min=fmt.emin)
    step = ((e - fmt.mbits + _F32_BIAS) << _F32_MANT).view(torch.float32)
    scaled = mag / step  # step is a power of two: exact
    if noise is None:
        q = torch.round(scaled)
    else:
        q = torch.floor(scaled + noise.to(torch.float32))
    out = torch.clamp(q * step, max=fmt.max_value)
    return torch.copysign(out, xf).to(orig_dtype)


def pow2_floor(s: torch.Tensor) -> torch.Tensor:
    """Largest power of two <= ``s`` (positive normal f32), exactly."""
    bits = s.to(torch.float32).contiguous().view(torch.int32)
    return (bits & 0x7F800000).view(torch.float32)


def group_scale(amax: torch.Tensor, fmt, pow2: bool = False
                ) -> torch.Tensor:
    """Per-group scale ``alpha = max(amax, 1e-12) / Q_max`` in f32.

    The divisor is a tensor on ``amax``'s device, never a Python float:
    PyTorch's CUDA division by a CPU scalar multiplies by its reciprocal,
    one ulp off the true division the reference and the kernels use.
    """
    a = torch.clamp(amax.to(torch.float32), min=1e-12)
    s = a / torch.full_like(a, fmt.max_value)
    if pow2:
        s = pow2_floor(s)
    return s


def quantize_tile(tile: torch.Tensor, fmt, *, per_row: bool,
                  pow2: bool = False,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QDQ a tile: per-row (1 x cols) scales or one whole-tile scale."""
    mag = tile.abs()
    amax = (mag.amax(dim=-1, keepdim=True) if per_row else mag.amax())
    sc = group_scale(amax, fmt, pow2).to(tile.dtype)
    return round_to_grid(tile / sc, fmt, noise) * sc
