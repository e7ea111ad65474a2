"""The shared bit-exact rounding codec (counterpart of
``repro.kernels.rounding``): the plain PyTorch form of what
``kernels/csrc/codec.cuh`` computes on the card.

``round_to_grid`` takes the binade exponent from the f32 bit pattern and
assembles the grid step by writing the exponent field back, so every
intermediate is exact.  ``quantize_tile`` is the group QDQ in the
reference's dtype order: amax in the input dtype, scale in f32 (true
division, eps floor), cast to the input dtype, divide, round, rescale in
the input dtype.

``hash_bits`` is the reference's counter hash for stochastic rounding:
every element's noise is a hash of (seed, global row, global col), so it
does not depend on how a kernel tiles the operand.  uint32 arithmetic is
carried in int64 masked to 32 bits (PyTorch's ``uint32`` has no ``>>``
or ``+`` on the CPU); products are split into 16-bit halves so no int64
intermediate overflows.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["round_to_grid", "pow2_floor", "group_scale", "quantize_tile",
           "snap_to_dtype", "hash_bits", "hash_uniform",
           "uniform_from_bits", "fold_seed"]

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


# ---------------------------------------------------------------------------
# Counter-based uniform noise (stochastic rounding)
# ---------------------------------------------------------------------------

_MASK = 0xFFFFFFFF
_PHI = 0x9E3779B9   # golden-ratio increment
_M1 = 0x85EBCA6B    # murmur3 finalizer constants
_M2 = 0xC2B2AE35


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for int64 ``a`` in [0, 2^32) and a uint32
    constant ``c``, without an int64 overflow."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def hash_bits(shape, seed: int, row0: int = 0, col0: int = 0,
              device=None) -> torch.Tensor:
    """uint32 hash bits (as int64) keyed by (seed, global row, global
    col) for a ``shape`` = (rows, cols) tile at offset (row0, col0)."""
    rows, cols = shape
    r = (torch.arange(rows, dtype=torch.int64, device=device) + row0) & _MASK
    c = (torch.arange(cols, dtype=torch.int64, device=device) + col0) & _MASK
    h = ((seed & _MASK) * _PHI) & _MASK
    h = _mix(h ^ _mul32(r, _M1))[:, None]
    return _mix(h ^ _mul32(c, _M2)[None, :])


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> f32 uniform [0, 1) from the top 24 bits (exact)."""
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def hash_uniform(shape, seed: int, row0: int = 0, col0: int = 0,
                 device=None) -> torch.Tensor:
    """f32 uniform [0, 1) noise keyed by (seed, global element)."""
    return uniform_from_bits(hash_bits(shape, seed, row0, col0, device))


def fold_seed(key_data, salt: int, which: int) -> int:
    """The int32 kernel seed of raw uint32[2] key material, a salt (0 fwd,
    2 dgrad, 4 wgrad) and the operand index (0 A, 1 B): the reference's
    folding, on host integers."""
    k0, k1 = (int(v) & _MASK for v in key_data)
    base = k0 ^ ((k1 * _PHI) & _MASK)
    base ^= ((salt * 2 + which) * _M1) & _MASK
    return base - (1 << 32) if base >= 1 << 31 else base
