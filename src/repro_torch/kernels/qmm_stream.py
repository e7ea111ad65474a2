"""``qmm_stream``: the single-pass quantize-into-the-matmul pipeline —
CUDA kernel ``csrc/qmm_stream.cu``, replacing
``repro/kernels/fp4_matmul.py::_stream_kernel``.

``y = Q(A') @ Q(B')`` for A' (M, K), B' (K, N), each operand ``pass``,
``block`` (1 x 128 groups along K) or ``tile`` (128 x 128), f32
accumulation, output in A's dtype.  ``A' = a.T`` under ``trans_a`` and
``B' = b.T`` under ``trans_b``: the kernel reads the stored layout in
place.  Ragged M / N / K edges are masked in
the kernel; the result equals the reference's zero-padded computation
sliced back to (M, N).  ``qmm_stream_plain`` is the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (CudaKernel, cuda_operands,
                                       effective_dims, stream_ptr)
from repro_torch.kernels.quantize_rows import MODE_CODES, fmt_args, mode_spec
from repro_torch.kernels.ref import qmm_ref

__all__ = ["qmm_stream", "qmm_stream_plain", "KERNEL", "STREAM_MODES"]

STREAM_MODES = ("pass", "block", "tile")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("qmm_stream",
                    [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _F, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P])


def qmm_stream_plain(a: torch.Tensor, b: torch.Tensor, *, a_mode: str,
                     b_mode: str, a_fmt: str, b_fmt: str,
                     a_pow2: bool = False, b_pow2: bool = False,
                     trans_a: bool = False, trans_b: bool = False
                     ) -> torch.Tensor:
    """Plain PyTorch version: unfused QDQ of both operands, then an
    f32-accumulated product."""
    return qmm_ref(a, b, mode_spec(a_mode, a_fmt, a_pow2),
                   mode_spec(b_mode, b_fmt, b_pow2),
                   trans_a=trans_a, trans_b=trans_b)


def qmm_stream(a: torch.Tensor, b: torch.Tensor, *, a_mode: str,
               b_mode: str, a_fmt: str, b_fmt: str, a_pow2: bool = False,
               b_pow2: bool = False, trans_a: bool = False,
               trans_b: bool = False, a_sr: bool = False,
               b_sr: bool = False, collect_stats: bool = False
               ) -> torch.Tensor:
    """``Q(A') @ Q(B')``; CUDA tensors launch the kernel, CPU tensors take
    the plain version.  Stochastic rounding and the stats epilogue are not
    ported and raise on every device."""
    if a_sr or b_sr or collect_stats:
        raise NotImplementedError(
            "qmm_stream: stochastic rounding and the stats epilogue are not "
            "ported yet")
    for mode in (a_mode, b_mode):
        if mode not in STREAM_MODES:
            raise ValueError(f"the stream pipeline takes {STREAM_MODES}, "
                             f"not {mode!r}")
    if a.device.type == "cpu":
        return qmm_stream_plain(a, b, a_mode=a_mode, b_mode=b_mode,
                                a_fmt=a_fmt, b_fmt=b_fmt, a_pow2=a_pow2,
                                b_pow2=b_pow2, trans_a=trans_a,
                                trans_b=trans_b)
    dtype = cuda_operands(a, b)
    m, k, n = effective_dims(a, b, trans_a, trans_b)
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    with torch.cuda.device(a.device):
        KERNEL.launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                      dtype, MODE_CODES[a_mode], MODE_CODES[b_mode],
                      *fmt_args(a_mode, a_fmt, a_pow2),
                      *fmt_args(b_mode, b_fmt, b_pow2), int(trans_a),
                      int(trans_b), stream_ptr(a), trans=trans_a or trans_b)
    return c
