"""``qmm_stream``: the single-pass quantize-into-the-matmul pipeline —
CUDA kernel ``csrc/qmm_stream.cu``, replacing
``repro/kernels/fp4_matmul.py::_stream_kernel``.

``y = Q(A') @ Q(B')`` for A' (M, K), B' (K, N), each operand ``pass``,
``block`` (1 x 128 groups along K) or ``tile`` (128 x 128), f32
accumulation, output in A's dtype.  ``A' = a.T`` under ``trans_a`` and
``B' = b.T`` under ``trans_b``: the kernel reads the stored layout in
place.  Ragged M / N / K edges are masked in
the kernel; the result equals the reference's zero-padded computation
sliced back to (M, N).  ``a_sr`` / ``b_sr`` round an operand
stochastically with the counter-hash noise of its seed, keyed in its
quant orientation ((M, K) for A, (N, K) for B).  ``collect_stats`` adds
the stats epilogue of each quantized operand.  bf16 calls with M > 16
run on the tensor cores, f32 and M <= 16 on CUDA-core FMA loops (the
library's rule, ``KERNEL.tensor_core``; ``tiled_mm`` follows the same
one).  3-D operands (E, ., .) run E products in one batched launch (the
MoE experts, each pair as it would run alone, every pair with the same
SR noise; no stats).  ``bm`` / ``bn``: the tensor-core route's output
tiling, one of ``build.TILINGS`` (128 x 128 unless the caller says;
``fused_qmm`` resolves it from the tuning table); an unbuilt one raises
``ValueError``.  The FMA route keeps its own fixed tiles, so there a
tiling changes nothing, and no tiling changes a value.
``qmm_stream_plain`` is the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import routing
from repro_torch.kernels.build import (CudaKernel, batch_of, check_tiling,
                                       cuda_operands, effective_dims,
                                       stats_buffers, stream_ptr)
from repro_torch.kernels.quantize_rows import (MODE_CODES, fmt_args,
                                               mode_spec, seed_arg, sr_noise)
from repro_torch.kernels.ref import f32_matmul, qdq_grid_ref, \
    quant_stats_ref

__all__ = ["qmm_stream", "qmm_stream_plain", "KERNEL", "STREAM_MODES"]

STREAM_MODES = ("pass", "block", "tile")

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
KERNEL = CudaKernel("qmm_stream",
                    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _F, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                     _I, _U, _I, _U, _P, _P, _I, _I, _P])


def qmm_stream_plain(a: torch.Tensor, b: torch.Tensor, *, a_mode: str,
                     b_mode: str, a_fmt: str, b_fmt: str,
                     a_pow2: bool = False, b_pow2: bool = False,
                     trans_a: bool = False, trans_b: bool = False,
                     seed_a=None, seed_b=None, collect_stats: bool = False,
                     bm: int = 128, bn: int = 128):
    """Plain PyTorch version: unfused QDQ of both operands (SR noise of
    ``seed_a`` / ``seed_b`` when given), then an f32-accumulated product;
    with ``collect_stats`` also the stats vectors (None for a pass
    operand).  3-D operands pair by pair (no stats).  ``bm`` / ``bn`` are
    taken and ignored: a tiling never changes a value."""
    if a.dim() == 3:
        if collect_stats:
            raise ValueError("a batched product has no stats")
        return torch.stack([qmm_stream_plain(
            x, y, a_mode=a_mode, b_mode=b_mode, a_fmt=a_fmt, b_fmt=b_fmt,
            a_pow2=a_pow2, b_pow2=b_pow2, trans_a=trans_a, trans_b=trans_b,
            seed_a=seed_a, seed_b=seed_b) for x, y in zip(a, b)])
    ae = a.T if trans_a else a
    bq_orient = b if trans_b else b.T          # B in quant orientation
    (m, k), n = ae.shape, bq_orient.shape[0]
    spec_a = mode_spec(a_mode, a_fmt, a_pow2)
    spec_b = mode_spec(b_mode, b_fmt, b_pow2)
    aq = qdq_grid_ref(ae, spec_a, 1, sr_noise(m, k, seed_a, a.device))
    bq = qdq_grid_ref(bq_orient, spec_b, 1, sr_noise(n, k, seed_b, b.device))
    y = f32_matmul(aq, bq.T, a.dtype)
    if not collect_stats:
        return y
    return y, tuple(None if mode == "pass" else quant_stats_ref(x, q, spec)
                    for mode, x, q, spec in ((a_mode, ae, aq, spec_a),
                                             (b_mode, bq_orient, bq, spec_b)))


def qmm_stream(a: torch.Tensor, b: torch.Tensor, *, a_mode: str,
               b_mode: str, a_fmt: str, b_fmt: str, a_pow2: bool = False,
               b_pow2: bool = False, trans_a: bool = False,
               trans_b: bool = False, a_sr: bool = False,
               b_sr: bool = False, seed_a=None, seed_b=None,
               collect_stats: bool = False, bm: int = 128, bn: int = 128):
    """``Q(A') @ Q(B')``, or ``(y, (stats_a, stats_b))`` with
    ``collect_stats`` (None for a pass operand); CUDA tensors launch the
    kernel (and, with stats, the two fold kernels) at tiling (bm, bn),
    CPU tensors take the plain version."""
    check_tiling(bm, bn)
    for mode in (a_mode, b_mode):
        if mode not in STREAM_MODES:
            raise ValueError(f"the stream pipeline takes {STREAM_MODES}, "
                             f"not {mode!r}")
    a_sr, b_sr = a_sr and a_mode != "pass", b_sr and b_mode != "pass"
    if (a_sr and seed_a is None) or (b_sr and seed_b is None):
        raise ValueError("stochastic rounding needs a seed")
    if collect_stats and a.dim() == 3:
        raise ValueError("a batched product has no stats")
    seed_a, seed_b = (seed_a if a_sr else None), (seed_b if b_sr else None)
    if a.device.type == "cpu":
        routing.mark_kernel(KERNEL.name, (a, b))
        return qmm_stream_plain(a, b, a_mode=a_mode, b_mode=b_mode,
                                a_fmt=a_fmt, b_fmt=b_fmt, a_pow2=a_pow2,
                                b_pow2=b_pow2, trans_a=trans_a,
                                trans_b=trans_b, seed_a=seed_a,
                                seed_b=seed_b, collect_stats=collect_stats)
    dtype = cuda_operands(a, b)
    m, k, n = effective_dims(a, b, trans_a, trans_b)
    c = torch.empty((*a.shape[:-2], m, n), dtype=a.dtype, device=a.device)
    stats = [stats_buffers(rows, k, a.device)
             if collect_stats and mode != "pass" else None
             for mode, rows in ((a_mode, m), (b_mode, n))]
    if c.numel() == 0:
        return (c, tuple(s and s[-1].zero_() for s in stats)) \
            if collect_stats else c
    ptrs = [None if s is None else (ctypes.c_void_p * 3)(
        *(t.data_ptr() for t in s)) for s in stats]
    n_stats = sum(s is not None for s in stats)
    with torch.cuda.device(a.device):
        KERNEL.launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                      batch_of(a), dtype, MODE_CODES[a_mode],
                      MODE_CODES[b_mode],
                      *fmt_args(a_mode, a_fmt, a_pow2),
                      *fmt_args(b_mode, b_fmt, b_pow2), int(trans_a),
                      int(trans_b), int(a_sr), seed_arg(seed_a), int(b_sr),
                      seed_arg(seed_b), *ptrs, bm, bn, stream_ptr(a),
                      operands=(a, b), kernels=1 + 2 * (n_stats > 0),
                      trans=trans_a or trans_b,
                      sr=a_sr or b_sr, stats=n_stats > 0,
                      tc=KERNEL.tensor_core(dtype, m),
                      batched=a.dim() == 3, tiles=(bm, bn))
    if not collect_stats:
        return c
    return c, tuple(None if s is None else s[-1] for s in stats)
