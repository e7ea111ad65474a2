"""Quantized linear, forward only (counterpart of
``repro.core.qlinear``).

``qlinear(x, w, recipe, impl=...)`` runs ``y = Q(x) @ Q(w)`` with the
recipe's forward specs.  ``impl`` is the config's ``linear_impl``:

* ``"qdq"`` — unfused QDQ then a matmul in the input dtype (``dot_qdq``);
* ``"pallas"`` / ``"pallas_two_pass"`` — the fused pipeline of
  ``kernels.fp4_matmul`` (the hand-written CUDA kernels), streaming by
  default or pinned to the two-pass pipeline.  A spec the kernels cannot
  realize (``kernel_unsupported_reason``) raises ``NotImplementedError``
  on a CUDA tensor: the card path launches its kernels or fails.  On a
  CPU tensor that matmul takes ``dot_qdq``, the reference's fallback.

A ``PackedTensor`` weight takes ``packed_linear``: the quantize-once panel
is expanded (bitwise equal to the training QDQ) and fed to the matmul as a
pass-mode operand, so only the activations are quantized per call.
This slice has no backward: the STE gradients come with training.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.packed import PackedTensor
from repro_torch.core.quantize import BF16_SPEC, QuantSpec, qdq
from repro_torch.core.recipe import MatmulRecipe

__all__ = ["qlinear", "packed_linear", "dot_qdq", "kernel_quant_mode",
           "kernel_unsupported_reason", "LINEAR_IMPLS"]

LINEAR_IMPLS = ("qdq", "pallas", "pallas_two_pass")
_KERNEL_BLOCK = 128


def dot_qdq(a: torch.Tensor, b: torch.Tensor, spec_a: QuantSpec,
            spec_b: QuantSpec) -> torch.Tensor:
    """QDQ both operands of ``a @ b`` (reduction axes 1 and 0), then the
    matmul in the input dtype."""
    return torch.matmul(qdq(a, spec_a, 1), qdq(b, spec_b, 0))


def kernel_unsupported_reason(spec: QuantSpec) -> Optional[str]:
    """Why the fused kernels cannot realize ``spec`` (the reference's
    structured ``"<code>: <detail>"`` vocabulary), or None."""
    if spec.is_passthrough:
        return None
    if spec.fmt == "fp16":
        return ("unsupported_dtype: fp16 is clip-only (no kernel "
                "rounding grid)")
    if spec.granularity in ("block", "tile"):
        if spec.block != _KERNEL_BLOCK:
            return (f"unsupported_block: {spec.granularity}{spec.block} "
                    f"(kernel group size is {_KERNEL_BLOCK})")
        return None
    if spec.granularity in ("token", "tensor"):
        return None
    return f"unsupported_granularity: {spec.granularity!r}"


def kernel_quant_mode(spec: QuantSpec) -> Optional[str]:
    """The kernels' quantization mode realizing ``spec`` (``pass`` for
    passthrough), or None when they cannot."""
    if kernel_unsupported_reason(spec) is not None:
        return None
    if spec.is_passthrough:
        return "pass"
    return spec.granularity


def _dot_fused(a: torch.Tensor, b: torch.Tensor, spec_a: QuantSpec,
               spec_b: QuantSpec, *, pipeline: Optional[str] = None
               ) -> torch.Tensor:
    """One matmul through the fused kernels.  A spec they cannot realize
    raises on a CUDA tensor and takes ``dot_qdq`` on a CPU tensor."""
    mode_a, mode_b = kernel_quant_mode(spec_a), kernel_quant_mode(spec_b)
    if mode_a is None or mode_b is None:
        if a.device.type == "cpu":
            return dot_qdq(a, b, spec_a, spec_b)
        reasons = [r for r in (kernel_unsupported_reason(spec_a),
                               kernel_unsupported_reason(spec_b)) if r]
        raise NotImplementedError(
            f"the CUDA kernels cannot run {spec_a.to_str()} x "
            f"{spec_b.to_str()}: {'; '.join(reasons)}")
    from repro_torch.kernels.ops import pallas_qmm
    return pallas_qmm(a, b, spec_a, spec_b, mode_a=mode_a, mode_b=mode_b,
                      pipeline=pipeline)


def _check_impl(impl: str) -> Optional[str]:
    """The pipeline an impl pins (None = default), or raise."""
    if impl not in LINEAR_IMPLS:
        raise ValueError(f"unknown linear_impl {impl!r}; have "
                         f"{list(LINEAR_IMPLS)}")
    return "two_pass" if impl == "pallas_two_pass" else None


def packed_linear(x: torch.Tensor, w: PackedTensor, recipe: MatmulRecipe,
                  *, bias: Optional[torch.Tensor] = None,
                  impl: str = "qdq") -> torch.Tensor:
    """Serving linear over a quantize-once ``PackedTensor`` panel."""
    pipeline = _check_impl(impl)
    k = x.shape[-1]
    w_dq = w.dequantize().to(x.dtype)
    spec_x = recipe.fwd_x
    x2d = x.reshape(-1, k)
    if spec_x.is_passthrough:
        y = torch.matmul(x2d, w_dq)
    elif impl == "qdq":
        y = dot_qdq(x2d, w_dq, spec_x, BF16_SPEC)
    else:
        y = _dot_fused(x2d.contiguous(), w_dq.contiguous(), spec_x,
                       BF16_SPEC, pipeline=pipeline)
    y = y.reshape(*x.shape[:-1], w_dq.shape[-1])
    if bias is not None:
        y = y + bias
    return y


def qlinear(x: torch.Tensor, w, recipe: MatmulRecipe, *,
            bias: Optional[torch.Tensor] = None,
            impl: str = "qdq") -> torch.Tensor:
    """Linear over the last axis of ``x``: (..., K) @ (K, N) -> (..., N),
    quantized per the recipe's forward specs."""
    if isinstance(w, PackedTensor):
        return packed_linear(x, w, recipe, bias=bias, impl=impl)
    pipeline = _check_impl(impl)
    k = x.shape[-1]
    x2d = x.reshape(-1, k)
    if recipe.is_passthrough:
        y = torch.matmul(x2d, w)
    elif impl == "qdq":
        y = dot_qdq(x2d, w, recipe.fwd_x, recipe.fwd_w)
    else:
        y = _dot_fused(x2d.contiguous(), w.contiguous(), recipe.fwd_x,
                       recipe.fwd_w, pipeline=pipeline)
    y = y.reshape(*x.shape[:-1], w.shape[-1])
    if bias is not None:
        y = y + bias
    return y
