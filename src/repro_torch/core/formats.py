"""Low-bit floating-point formats and the round-to-nearest codec
(counterpart of ``repro.core.formats``).

A signed format with ``e`` exponent and ``m`` mantissa bits rounds onto
the per-binade grid ``2^(floor(log2|x|) - m)`` (paper App. A, Eq. 5-7),
subnormals on the fixed grid ``2^(emin - m)``, saturating at
``max_value``.  ``round_to_format`` computes that grid with the exact
integer codec of ``kernels.rounding`` (exponent field arithmetic, no
transcendentals), which the reference's tests prove equal to its
``log2``/``ldexp`` form on every exponent boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["FloatFormat", "FORMATS", "FP4_E2M1", "FP8_E4M3", "FP8_E5M2",
           "BF16", "FP16", "FP32", "round_to_format", "format_values_host"]


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """A signed low-bit float format; ``passthrough`` formats are the
    identity codec (bf16/f32; fp16 clips)."""

    name: str
    ebits: int
    mbits: int
    max_value: float
    emin: int
    passthrough: bool = False

    @property
    def bits(self) -> int:
        return 1 + self.ebits + self.mbits

    @property
    def min_subnormal(self) -> float:
        return 2.0 ** (self.emin - self.mbits)

    @property
    def min_normal(self) -> float:
        return 2.0 ** self.emin


def _mk(name, e, m, max_value, emin, passthrough=False):
    return FloatFormat(name, e, m, max_value, emin, passthrough)


FP4_E2M1 = _mk("fp4_e2m1", 2, 1, 6.0, 0)
FP4_E1M2 = _mk("fp4_e1m2", 1, 2, 3.5, 0)
FP6_E2M3 = _mk("fp6_e2m3", 2, 3, 7.5, 0)
FP6_E3M2 = _mk("fp6_e3m2", 3, 2, 28.0, -2)
FP8_E4M3 = _mk("fp8_e4m3", 4, 3, 448.0, -6)
FP8_E5M2 = _mk("fp8_e5m2", 5, 2, 57344.0, -14)
BF16 = _mk("bf16", 8, 7, 3.38953139e38, -126, passthrough=True)
FP16 = _mk("fp16", 5, 10, 65504.0, -14, passthrough=True)
FP32 = _mk("fp32", 8, 23, 3.4028235e38, -126, passthrough=True)

FORMATS = {
    f.name: f
    for f in (FP4_E2M1, FP4_E1M2, FP6_E2M3, FP6_E3M2, FP8_E4M3, FP8_E5M2,
              BF16, FP16, FP32)
}


def format_values_host(fmt: FloatFormat) -> list:
    """Non-negative representable values of a low-bit format, ascending."""
    if fmt.passthrough or fmt.bits > 8:
        raise ValueError(f"{fmt.name} has no enumerable grid")
    vals = [0.0]
    step = fmt.min_subnormal
    for i in range(1, 2 ** fmt.mbits):
        vals.append(i * step)
    e = fmt.emin
    while True:
        base = 2.0 ** e
        for i in range(2 ** fmt.mbits):
            v = base * (1.0 + i / (2 ** fmt.mbits))
            if v > fmt.max_value:
                return sorted(set(vals))
            vals.append(v)
        e += 1


def round_to_format(x: torch.Tensor, fmt: FloatFormat, *,
                    generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
    """Round ``x`` (already scaled) onto ``fmt``'s grid, saturating at
    ``fmt.max_value``.  RTN half-to-even; with ``generator``, unbiased
    stochastic rounding ``floor(t + u)`` (equal to the reference only in
    distribution: its noise comes from ``jax.random``)."""
    if fmt.passthrough:
        if fmt is FP16:
            return torch.clamp(x, -fmt.max_value, fmt.max_value)
        return x
    from repro_torch.kernels.rounding import round_to_grid
    noise = None
    if generator is not None:
        noise = torch.rand(x.shape, generator=generator,
                           device=x.device, dtype=torch.float32)
    return round_to_grid(x, fmt, noise)
