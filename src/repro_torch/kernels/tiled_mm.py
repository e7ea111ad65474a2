"""``tiled_mm``: the matmul pass (phase 2 of the two-pass pipeline) —
CUDA kernel ``csrc/tiled_mm.cu``, replacing
``repro/kernels/fp4_matmul.py::_mm_kernel``.

``y = A' @ B'`` over pre-quantized or pass-mode operands, f32
accumulation, output in A's dtype; ``A' = a.T`` under ``trans_a`` and
``B' = b.T`` under ``trans_b``, read in place.  bf16 calls with M > 16
run on the tensor cores, f32 and M <= 16 on CUDA-core FMA loops, the
same rule as ``qmm_stream`` (``KERNEL.tensor_core``).  3-D operands
(E, ., .) run E products in one batched launch (the MoE experts; the
trans flags act on each pair's last two dims).  ``bm`` / ``bn``: the
tensor-core route's output tiling, as in ``qmm_stream`` (the FMA route
ignores it; an unbuilt one raises).  ``tiled_mm_plain`` is the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import routing
from repro_torch.kernels.build import (CudaKernel, batch_of, check_tiling,
                                       cuda_operands, effective_dims,
                                       stream_ptr)
from repro_torch.kernels.ref import f32_matmul

__all__ = ["tiled_mm", "tiled_mm_plain", "KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("tiled_mm", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                 _I, _I, _P])


def tiled_mm_plain(a: torch.Tensor, b: torch.Tensor, *,
                   trans_a: bool = False, trans_b: bool = False,
                   bm: int = 128, bn: int = 128) -> torch.Tensor:
    """Plain PyTorch version: f32-accumulated ``A' @ B'`` in A's dtype;
    3-D operands pair by pair; ``bm`` / ``bn`` taken and ignored."""
    if a.dim() == 3:
        return torch.stack([tiled_mm_plain(x, y, trans_a=trans_a,
                                           trans_b=trans_b)
                            for x, y in zip(a, b)])
    return f32_matmul(a.T if trans_a else a, b.T if trans_b else b, a.dtype)


def tiled_mm(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
             trans_b: bool = False, bm: int = 128,
             bn: int = 128) -> torch.Tensor:
    """``A' @ B'``; CUDA tensors launch the kernel at tiling (bm, bn), CPU
    tensors take the plain version."""
    check_tiling(bm, bn)
    if a.device.type == "cpu":
        routing.mark_kernel(KERNEL.name, (a, b))
        return tiled_mm_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    dtype = cuda_operands(a, b)
    m, k, n = effective_dims(a, b, trans_a, trans_b)
    c = torch.empty((*a.shape[:-2], m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    with torch.cuda.device(a.device):
        KERNEL.launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                      batch_of(a), dtype, int(trans_a), int(trans_b),
                      bm, bn, stream_ptr(a), operands=(a, b),
                      trans=trans_a or trans_b,
                      tc=KERNEL.tensor_core(dtype, m),
                      batched=a.dim() == 3, tiles=(bm, bn))
    return c
