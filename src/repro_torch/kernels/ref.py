"""Plain PyTorch oracles for the kernels (counterpart of
``repro.kernels.ref``): unfused QDQ through the shared codec plus an
f32-accumulated product.  The kernels' plain versions are built on these.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import QuantSpec, qdq

__all__ = ["quantize_panels_ref", "qmm_ref"]


def quantize_panels_ref(t: torch.Tensor, spec: QuantSpec, *,
                        trans: bool = False) -> torch.Tensor:
    """QDQ of the effective (post-transpose) operand, groups along its
    axis 1 (the oracle of ``fp4_matmul.quantize_panels``)."""
    return qdq(t.T if trans else t, spec, 1)


def qmm_ref(a: torch.Tensor, b: torch.Tensor, spec_a: QuantSpec,
            spec_b: QuantSpec, *, trans_a: bool = False,
            trans_b: bool = False) -> torch.Tensor:
    """Q(A') @ Q(B') with f32 accumulation, output in ``a.dtype``; A' is
    quantized along its axis 1 and B' along its axis 0 (the reduction
    axis of each)."""
    aq = qdq(a.T if trans_a else a, spec_a, 1)
    bq = qdq(b.T if trans_b else b, spec_b, 0)
    return torch.matmul(aq.to(torch.float32),
                        bq.to(torch.float32)).to(a.dtype)
