"""``tiled_mm``: the matmul pass (phase 2 of the two-pass pipeline) —
CUDA kernel ``csrc/tiled_mm.cu``, replacing
``repro/kernels/fp4_matmul.py::_mm_kernel``.

``y = A @ B`` over pre-quantized or pass-mode operands, f32
accumulation, output in A's dtype.  ``tiled_mm_plain`` is the plain
version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import CudaKernel, cuda_operands, stream_ptr

__all__ = ["tiled_mm", "tiled_mm_plain", "KERNEL"]

_P, _I = ctypes.c_void_p, ctypes.c_int
KERNEL = CudaKernel("tiled_mm", [_P, _P, _P, _I, _I, _I, _I, _P])


def tiled_mm_plain(a: torch.Tensor, b: torch.Tensor, *,
                   trans_a: bool = False, trans_b: bool = False
                   ) -> torch.Tensor:
    """Plain PyTorch version: f32-accumulated ``A' @ B'`` in A's dtype."""
    ae = a.T if trans_a else a
    be = b.T if trans_b else b
    return torch.matmul(ae.to(torch.float32),
                        be.to(torch.float32)).to(a.dtype)


def tiled_mm(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
             trans_b: bool = False) -> torch.Tensor:
    """``A' @ B'``; CUDA tensors launch the kernel, CPU tensors take the
    plain version.  Transposed layouts raise on CUDA (training slice)."""
    if a.device.type == "cpu":
        return tiled_mm_plain(a, b, trans_a=trans_a, trans_b=trans_b)
    if trans_a or trans_b:
        raise NotImplementedError(
            "tiled_mm: transposed layouts (dgrad / wgrad) are not ported "
            "yet")
    dtype = cuda_operands(a, b)
    (m, k), (kb, n) = a.shape, b.shape
    if k != kb:
        raise ValueError(f"inner dims differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if c.numel() == 0:
        return c
    with torch.cuda.device(a.device):
        KERNEL.launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                      dtype, stream_ptr(a))
    return c
