"""Quantized-matmul pipelines over the CUDA kernels (counterpart of
``repro.kernels.fp4_matmul``).

``fused_qmm`` computes ``Q(A') @ Q(B')`` through one of two pipelines:

* ``stream`` — one launch of ``qmm_stream``: every K tile is quantized
  inside the matmul loop, the quantized panels never reach device memory;
* ``two_pass`` — ``quantize_rows`` on each quantized operand, then
  ``tiled_mm``.

``token``/``tensor`` scales span the whole reduction axis, so their amax
must be complete before any element quantizes: those modes always take
``two_pass`` (``resolve_pipeline``), as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.qmm_stream import qmm_stream
from repro_torch.kernels.quantize_rows import quantize_rows
from repro_torch.kernels.tiled_mm import tiled_mm

__all__ = ["QUANT_MODES", "PIPELINES", "stream_supported",
           "resolve_pipeline", "quantize_panels", "fused_qmm"]

QUANT_MODES = ("pass", "block", "tile", "token", "tensor")
PIPELINES = ("stream", "two_pass")


def stream_supported(a_mode: str, b_mode: str) -> bool:
    """Whether the streaming pipeline can run this granularity pair."""
    streamable = ("pass", "block", "tile")
    return a_mode in streamable and b_mode in streamable


def resolve_pipeline(pipeline: Optional[str], a_mode: str,
                     b_mode: str) -> str:
    """The pipeline ``fused_qmm`` runs: the explicit choice (default
    ``stream``), demoted to ``two_pass`` for a pair that cannot stream."""
    pipeline = pipeline or "stream"
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}")
    if pipeline == "stream" and not stream_supported(a_mode, b_mode):
        pipeline = "two_pass"
    return pipeline


def quantize_panels(t: torch.Tensor, *, mode: str = "block",
                    fmt_name: str = "fp4_e2m1", pow2: bool = False,
                    sr: bool = False, trans: bool = False,
                    collect_stats: bool = False) -> torch.Tensor:
    """The quantize pass on its own: QDQ of the effective operand
    (``t.T`` under ``trans``), groups along its axis 1."""
    eff = t.T.contiguous() if trans else t
    return quantize_rows(eff, mode=mode, fmt_name=fmt_name, pow2=pow2,
                         sr=sr, collect_stats=collect_stats)


def fused_qmm(a: torch.Tensor, b: torch.Tensor, *,
              a_mode: str = "block", b_mode: str = "tile",
              a_fmt: str = "fp4_e2m1", b_fmt: str = "fp4_e2m1",
              a_pow2: bool = False, b_pow2: bool = False,
              a_sr: bool = False, b_sr: bool = False,
              trans_a: bool = False, trans_b: bool = False,
              pipeline: Optional[str] = None,
              collect_stats: bool = False) -> torch.Tensor:
    """``y = Q(A') @ Q(B')``; ``A' = a.T`` under ``trans_a`` (same for B').

    Effective shapes A' (M, K), B' (K, N), any sizes: the kernels mask the
    ragged edges, which equals the reference's zero padding to multiples
    of 128 sliced back.  Per-operand modes ``pass | block | tile | token |
    tensor``; groups of 128 along K.
    """
    if a_mode not in QUANT_MODES or b_mode not in QUANT_MODES:
        raise ValueError(f"unknown modes {(a_mode, b_mode)}")
    if resolve_pipeline(pipeline, a_mode, b_mode) == "stream":
        return qmm_stream(a, b, a_mode=a_mode, b_mode=b_mode, a_fmt=a_fmt,
                          b_fmt=b_fmt, a_pow2=a_pow2, b_pow2=b_pow2,
                          trans_a=trans_a, trans_b=trans_b, a_sr=a_sr,
                          b_sr=b_sr, collect_stats=collect_stats)
    # Stats, as in the reference, come from the quantized operands only.
    if a_mode != "pass":
        a = quantize_panels(a, mode=a_mode, fmt_name=a_fmt, pow2=a_pow2,
                            sr=a_sr, trans=trans_a,
                            collect_stats=collect_stats)
        trans_a = False
    if b_mode != "pass":
        # B's quant orientation is (N, K): groups reduce over K.
        b = quantize_panels(b, mode=b_mode, fmt_name=b_fmt, pow2=b_pow2,
                            sr=b_sr, trans=not trans_b,
                            collect_stats=collect_stats).T.contiguous()
        trans_b = False
    return tiled_mm(a, b, trans_a=trans_a, trans_b=trans_b)
