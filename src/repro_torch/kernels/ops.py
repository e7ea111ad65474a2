"""Public quantized-matmul entry point (counterpart of
``repro.kernels.ops.pallas_qmm``).

The reference pads every operand to multiples of 128 and slices the
result back to (M, N).  The port's kernels mask the ragged edges
instead, which gives the same values: zero K padding adds nothing to the
dot and leaves each row's amax groups unchanged, and padded M / N rows
and columns are exactly the ones sliced away.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantize import QuantSpec
from repro_torch.kernels.fp4_matmul import fused_qmm

__all__ = ["pallas_qmm"]


def pallas_qmm(a: torch.Tensor, b: torch.Tensor, spec_a: QuantSpec,
               spec_b: QuantSpec, *, mode_a: str, mode_b: str,
               trans_a: bool = False, trans_b: bool = False,
               pipeline: Optional[str] = None) -> torch.Tensor:
    """Per-role quantized matmul ``Q(A') @ Q(B')`` through the fused
    pipeline (``mode_*`` from ``core.qlinear.kernel_quant_mode``).  The
    name is the reference's; here it runs the CUDA kernels."""
    return fused_qmm(
        a, b, a_mode=mode_a, b_mode=mode_b, a_fmt=spec_a.fmt,
        b_fmt=spec_b.fmt, a_pow2=spec_a.pow2_scale,
        b_pow2=spec_b.pow2_scale,
        a_sr=spec_a.stochastic and mode_a != "pass",
        b_sr=spec_b.stochastic and mode_b != "pass",
        trans_a=trans_a, trans_b=trans_b, pipeline=pipeline)
