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

Transposed operands (dgrad's ``w^T``, wgrad's ``x^T``) are never copied:
every kernel reads the stored layout in place.  In ``two_pass`` the
quantize pass writes its result back in the stored layout of its operand
and the matmul pass reads it with the operand's trans flag, so each
kernel reads and writes along the contiguous axis.

Stochastic rounding (``a_sr`` / ``b_sr`` with ``seed_a`` / ``seed_b``)
keys each element's noise by its coordinates in the operand's quant
orientation, so both pipelines draw the same noise.  ``collect_stats``
adds the quantize telemetry epilogue: ``(y, (stats_a, stats_b))`` with
one (8,) f32 vector per quantized operand (None for ``pass``), folded in
one canonical order (``ref.quant_stats_ref``) by every kernel, so the
pipelines agree on them bit for bit; ``finalize_quant_stats`` reduces a
vector to the telemetry stats.

Tiling (the tensor-core route's ``(bm, bn, bk)``, the reference's rule):
explicit tiles win; when all three are omitted the tuning table
(``kernels.autotune``) is consulted, 128 x 128 x 128 on a miss; a partial
set skips the table (the rest 128).  Resolution happens per call on the
host, so a CUDA graph's capture sees a fixed tiling.  A tiling the
kernels are not built for raises ``ValueError``.  No tiling changes a
value.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels.build import (TILINGS, batch_of, check_tiling,
                                       effective_dims)
from repro_torch.kernels.qmm_stream import qmm_stream
from repro_torch.kernels.quantize_rows import quantize_rows
from repro_torch.kernels.ref import STATS_WIDTH
from repro_torch.kernels.tiled_mm import tiled_mm

__all__ = ["QUANT_MODES", "PIPELINES", "STATS_WIDTH", "stream_supported",
           "resolve_pipeline", "quantize_panels", "fused_qmm",
           "finalize_quant_stats", "default_pipeline", "use_pipeline",
           "resolve_qmm_tiles"]

BLOCK = 128           # the quant group edge, and the table's key block

QUANT_MODES = ("pass", "block", "tile", "token", "tensor")
PIPELINES = ("stream", "two_pass")


# A stack, so nested ``use_pipeline`` contexts unwind correctly.
_pipeline_stack = ["stream"]


def default_pipeline() -> str:
    """The pipeline ``fused_qmm`` runs when none is passed."""
    return _pipeline_stack[-1]


@contextlib.contextmanager
def use_pipeline(name: str):
    """Override the default pipeline inside (re-entrant)."""
    if name not in PIPELINES:
        raise ValueError(f"unknown pipeline {name!r}")
    _pipeline_stack.append(name)
    try:
        yield
    finally:
        _pipeline_stack.pop()


def stream_supported(a_mode: str, b_mode: str) -> bool:
    """Whether the streaming pipeline can run this granularity pair."""
    streamable = ("pass", "block", "tile")
    return a_mode in streamable and b_mode in streamable


def resolve_pipeline(pipeline: Optional[str], a_mode: str,
                     b_mode: str) -> str:
    """The pipeline ``fused_qmm`` runs: the explicit choice (default
    ``default_pipeline()``), demoted to ``two_pass`` for a pair that cannot
    stream."""
    pipeline = pipeline or default_pipeline()
    if pipeline not in PIPELINES:
        raise ValueError(f"unknown pipeline {pipeline!r}")
    if pipeline == "stream" and not stream_supported(a_mode, b_mode):
        pipeline = "two_pass"
    return pipeline


def finalize_quant_stats(vec: torch.Tensor):
    """Reduce a stats vector to the telemetry stat dict (clip, underflow,
    rel_err, scale_spread), f32 0-dim tensors, as the reference does.

    The square root is taken in f64 and rounded once to f32, which is the
    correctly rounded f32 root the reference computes (PyTorch's CPU f32
    ``sqrt`` is not correctly rounded for every input)."""
    v = vec.reshape(STATS_WIDTH).to(torch.float32)
    clip_c, under, nz, err2, val2, smin, smax, cnt = v.unbind()
    smin = torch.minimum(smin, smax)   # the init value if no valid group
    ratio = err2 / torch.clamp(val2, min=1e-30)
    return {
        "clip": clip_c / torch.clamp(cnt, min=1.0),
        "underflow": under / torch.clamp(nz, min=1.0),
        "rel_err": ratio.double().sqrt().float(),
        # log(x) / log(2), as jnp.log2 computes it
        "scale_spread": torch.log(torch.clamp(smax, min=1e-30)
                                  / torch.clamp(smin, min=1e-30))
        / torch.log(torch.full_like(smax, 2.0)),
    }


def quantize_panels(t: torch.Tensor, *, mode: str = "block",
                    fmt_name: str = "fp4_e2m1", pow2: bool = False,
                    sr: bool = False, seed=None, trans: bool = False,
                    collect_stats: bool = False):
    """The quantize pass on its own: QDQ of the effective operand
    (``t.T`` under ``trans``, read in place), groups along its axis 1;
    returned in the effective orientation, as the reference returns it,
    or ``(values, stats)`` with ``collect_stats``."""
    return quantize_rows(t, mode=mode, fmt_name=fmt_name, pow2=pow2,
                         trans=trans, sr=sr, seed=seed,
                         collect_stats=collect_stats)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def resolve_qmm_tiles(a: torch.Tensor, b: torch.Tensor, a_mode: str,
                      b_mode: str, trans_a: bool, trans_b: bool,
                      bm=None, bn=None, bk=None):
    """The ``(bm, bn, bk)`` a ``fused_qmm`` call runs at (module
    docstring) and the call's table key.  The key's dims are one pair's
    (M, N, K) rounded up to the block, as the reference pads before its
    lookup."""
    m, k, n = effective_dims(a, b, trans_a, trans_b)
    dims = tuple(-(-d // BLOCK) * BLOCK for d in (m, n, k))
    dtypes, modes = (_dtype_name(a), _dtype_name(b)), (a_mode, b_mode)
    key = autotune.tuning_key(*dims, dtypes, modes, (trans_a, trans_b),
                              BLOCK)
    if bm is None and bn is None and bk is None:
        bm, bn, bk = autotune.resolve_tiles(
            *dims, dtypes=dtypes, modes=modes, trans=(trans_a, trans_b),
            block=BLOCK) or TILINGS[0]
    else:
        bm, bn, bk = (BLOCK if t is None else t for t in (bm, bn, bk))
    check_tiling(bm, bn, bk)
    return (bm, bn, bk), key


def fused_qmm(a: torch.Tensor, b: torch.Tensor, *,
              a_mode: str = "block", b_mode: str = "tile",
              a_fmt: str = "fp4_e2m1", b_fmt: str = "fp4_e2m1",
              a_pow2: bool = False, b_pow2: bool = False,
              a_sr: bool = False, b_sr: bool = False,
              seed_a=None, seed_b=None,
              trans_a: bool = False, trans_b: bool = False,
              pipeline: Optional[str] = None,
              collect_stats: bool = False, bm: Optional[int] = None,
              bn: Optional[int] = None, bk: Optional[int] = None):
    """``y = Q(A') @ Q(B')``; ``A' = a.T`` under ``trans_a`` (same for B').

    Effective shapes A' (M, K), B' (K, N), any sizes: the kernels mask the
    ragged edges, which equals the reference's zero padding to multiples
    of 128 sliced back.  3-D operands (E, ., .) run E products, each as
    it would run alone, in one batched launch a kernel (the reference's
    ``jax.vmap`` over its kernels; no stats).  Per-operand modes ``pass | block | tile | token |
    tensor``; groups of 128 along K.  ``a_sr`` / ``b_sr`` need their
    seeds; with ``collect_stats`` returns ``(y, (stats_a, stats_b))``.
    ``bm`` / ``bn`` / ``bk``: the tiling (module docstring); a batched
    call keys on one pair's dims, as the reference's ``jax.vmap`` over
    its ``fused_qmm`` does.
    """
    if a_mode not in QUANT_MODES or b_mode not in QUANT_MODES:
        raise ValueError(f"unknown modes {(a_mode, b_mode)}")
    pipeline = resolve_pipeline(pipeline, a_mode, b_mode)
    (bm, bn, _), key = resolve_qmm_tiles(a, b, a_mode, b_mode, trans_a,
                                         trans_b, bm, bn, bk)
    if autotune.recording_now():
        m, k, n = effective_dims(a, b, trans_a, trans_b)
        autotune.note_call(
            key, m=m, n=n, k=k, a_mode=a_mode, b_mode=b_mode, a_fmt=a_fmt,
            b_fmt=b_fmt, a_pow2=a_pow2, b_pow2=b_pow2,
            dtype=_dtype_name(a), trans_a=trans_a, trans_b=trans_b,
            a_sr=a_sr, b_sr=b_sr, seed_a=seed_a, seed_b=seed_b,
            collect_stats=collect_stats,
            batch=batch_of(a) if a.dim() == 3 else 0, pipeline=pipeline)
    if pipeline == "stream":
        return qmm_stream(a, b, a_mode=a_mode, b_mode=b_mode, a_fmt=a_fmt,
                          b_fmt=b_fmt, a_pow2=a_pow2, b_pow2=b_pow2,
                          trans_a=trans_a, trans_b=trans_b, a_sr=a_sr,
                          b_sr=b_sr, seed_a=seed_a, seed_b=seed_b,
                          collect_stats=collect_stats, bm=bm, bn=bn)
    # Each quantize pass writes in its operand's stored layout (emit_trans
    # undoes trans), so tiled_mm keeps the original trans flags.  Stats, as
    # in the reference, come from the quantized operands only.
    stats = [None, None]
    if a_mode != "pass":
        # A's quant orientation (M, K) is A' itself.
        a = quantize_rows(a, mode=a_mode, fmt_name=a_fmt, pow2=a_pow2,
                          trans=trans_a, emit_trans=trans_a, sr=a_sr,
                          seed=seed_a, collect_stats=collect_stats)
        if collect_stats:
            a, stats[0] = a
    if b_mode != "pass":
        # B's quant orientation is (N, K) = B'.T: groups reduce over K.
        b = quantize_rows(b, mode=b_mode, fmt_name=b_fmt, pow2=b_pow2,
                          trans=not trans_b, emit_trans=not trans_b,
                          sr=b_sr, seed=seed_b, collect_stats=collect_stats)
        if collect_stats:
            b, stats[1] = b
    y = tiled_mm(a, b, trans_a=trans_a, trans_b=trans_b, bm=bm, bn=bn)
    return (y, tuple(stats)) if collect_stats else y
