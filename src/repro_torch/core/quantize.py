"""Scaled quantize-dequantize (QDQ) with the paper's granularities
(counterpart of ``repro.core.quantize``).

An operand is quantized by choosing ``alpha = amax / Q_max`` over a
granularity group, clipping to ``alpha * Q_max`` and rounding on the
low-bit grid (App. A, Eq. 1-7).  Granularities: ``tensor`` (one scale),
``token`` (one scale per vector along the reduction axis), ``block``
(1 x B segments along the reduction axis) and ``tile`` (B x B tiles).
All full-size intermediates stay in the input dtype; only the small
per-group scales are f32 — the reference's dtype discipline, which the
bitwise tests hold the port to.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import torch
import torch.nn.functional as F_nn

from repro_torch.core import formats as F
from repro_torch.kernels.rounding import group_scale, pow2_floor

__all__ = ["QuantSpec", "BF16_SPEC", "qdq", "quantize_dequantize",
           "compute_scale", "scale_from_amax", "pow2_floor"]


def scale_from_amax(amax: torch.Tensor, fmt: F.FloatFormat,
                    pow2: bool = False) -> torch.Tensor:
    """Per-group scale ``alpha = max(amax, 1e-12) / Q_max`` (Eq. 3), f32,
    true IEEE division."""
    return group_scale(amax, fmt, pow2)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How to quantize one matmul operand (same fields and string syntax
    as the reference's ``QuantSpec``)."""

    fmt: str = "bf16"
    granularity: str = "tensor"
    block: int = 128
    pow2_scale: bool = False
    stochastic: bool = False

    @property
    def format(self) -> F.FloatFormat:
        return F.FORMATS[self.fmt]

    @property
    def is_passthrough(self) -> bool:
        return self.format.passthrough and self.fmt != "fp16"

    def short(self) -> str:
        if self.is_passthrough:
            return self.fmt
        return f"{self.fmt}/{self.granularity}"

    def to_str(self) -> str:
        if self.is_passthrough:
            s = self.fmt
        else:
            s = f"{self.fmt}@{self.granularity}"
            if self.granularity in ("block", "tile"):
                s += str(self.block)
        if self.pow2_scale:
            s += ":pow2"
        if self.stochastic:
            s += ":sr"
        return s

    @classmethod
    def from_str(cls, s: str) -> "QuantSpec":
        head, *flags = s.split(":")
        bad = set(flags) - {"pow2", "sr"}
        if bad:
            raise ValueError(f"unknown QuantSpec flags {sorted(bad)} in {s!r}")
        pow2, sr = "pow2" in flags, "sr" in flags
        if "@" in head:
            fmt, gran = head.split("@", 1)
            m = re.fullmatch(r"([a-z]+)(\d+)?", gran)
            if not m or m.group(1) not in ("tensor", "token", "block",
                                           "tile"):
                raise ValueError(f"bad granularity {gran!r} in {s!r}")
            spec = cls(fmt, m.group(1), int(m.group(2) or 128),
                       pow2_scale=pow2, stochastic=sr)
        else:
            spec = cls(head, pow2_scale=pow2, stochastic=sr)
        if spec.fmt not in F.FORMATS:
            raise ValueError(f"unknown format {spec.fmt!r} in {s!r}")
        return spec


BF16_SPEC = QuantSpec("bf16")


def _blocked_view(x2d: torch.Tensor, granularity: str, block: int,
                  reduction_axis: int) -> torch.Tensor:
    """Zero-pad the blocked axes to a block multiple and reshape:
    block -> (rows, nb, B) [red=1] or (nb, B, cols) [red=0];
    tile -> (rb, B, cb, B); tensor/token -> x as-is."""
    rows, cols = x2d.shape
    if granularity in ("tensor", "token"):
        return x2d
    if granularity == "block":
        n = x2d.shape[reduction_axis]
        nb = -(-n // block)
        pad = nb * block - n
        if reduction_axis == 1:
            x2d = F_nn.pad(x2d, (0, pad))
            return x2d.reshape(rows, nb, block)
        x2d = F_nn.pad(x2d, (0, 0, 0, pad))
        return x2d.reshape(nb, block, cols)
    if granularity == "tile":
        rb, cb = -(-rows // block), -(-cols // block)
        x2d = F_nn.pad(x2d, (0, cb * block - cols, 0, rb * block - rows))
        return x2d.reshape(rb, block, cb, block)
    raise ValueError(f"unknown granularity: {granularity!r}")


def _group_amax(xb: torch.Tensor, granularity: str,
                reduction_axis: int) -> torch.Tensor:
    mag = xb.abs()  # amax in the input dtype (exact)
    if granularity == "tensor":
        return mag.amax()
    if granularity == "token":
        return mag.amax(dim=reduction_axis, keepdim=True)
    if granularity == "block":
        return mag.amax(dim=2 if reduction_axis == 1 else 1, keepdim=True)
    return mag.amax(dim=(1, 3), keepdim=True)


def compute_scale(x2d: torch.Tensor, spec: QuantSpec,
                  reduction_axis: int) -> torch.Tensor:
    """Per-group f32 scale in blocked layout (broadcastable against the
    blocked view of ``x2d``)."""
    xb = _blocked_view(x2d, spec.granularity, spec.block, reduction_axis)
    amax = _group_amax(xb, spec.granularity, reduction_axis)
    return scale_from_amax(amax, spec.format, spec.pow2_scale)


def quantize_dequantize(x2d: torch.Tensor, spec: QuantSpec,
                        reduction_axis: int, *,
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Simulated low-precision representation of ``x2d`` (Eq. 1-7), in
    ``x2d``'s dtype.  ``generator`` feeds stochastic specs."""
    if spec.is_passthrough:
        return x2d
    fmt = spec.format
    if spec.fmt == "fp16":
        return F.round_to_format(x2d, fmt)
    rows, cols = x2d.shape
    xb = _blocked_view(x2d, spec.granularity, spec.block, reduction_axis)
    scale = scale_from_amax(
        _group_amax(xb, spec.granularity, reduction_axis), fmt,
        spec.pow2_scale).to(x2d.dtype)
    gen = generator if spec.stochastic else None
    y = F.round_to_format(xb / scale, fmt, generator=gen) * scale
    if spec.granularity == "block" and reduction_axis == 1:
        y = y.reshape(rows, -1)
    elif spec.granularity == "block":
        y = y.reshape(-1, cols)
    elif spec.granularity == "tile":
        y = y.reshape(y.shape[0] * y.shape[1], y.shape[2] * y.shape[3])
    return y[:rows, :cols].to(x2d.dtype)


qdq = quantize_dequantize
