"""``quantize_blockwise``: standalone per-tile QDQ — CUDA kernel
``csrc/quantize_blockwise.cu``, replacing
``repro/kernels/quantize.py::_q_kernel``.

QDQ of a 2-D array with one scale per (128 x 128) tile, or per (1 x 128)
row segment under ``per_row``, round to nearest, computed in f32 and
returned in the input dtype.  Used where quantization is not fused into
a matmul.  ``quantize_blockwise_plain`` is the plain version
(``ref.quantize_blockwise_ref``); the wrapper takes it only for a tensor
on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import routing
from repro_torch.core.formats import FORMATS
from repro_torch.kernels.build import CudaKernel, cuda_operands, stream_ptr
from repro_torch.kernels.ref import quantize_blockwise_ref

__all__ = ["quantize_blockwise", "quantize_blockwise_plain", "KERNEL"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("quantize_blockwise", [_P, _P, _I, _I, _I, _I, _F, _I,
                                           _I, _P])
_BLOCK = 128


# The plain PyTorch version of the kernel (same bits).
quantize_blockwise_plain = quantize_blockwise_ref


def quantize_blockwise(x: torch.Tensor, fmt_name: str = "fp4_e2m1",
                       block: int = 128, *,
                       per_row: bool = False) -> torch.Tensor:
    """Tilewise QDQ of a 2-D array; CUDA tensors launch the kernel (group
    edge 128 only: another block size raises), CPU tensors take the plain
    version."""
    fmt = FORMATS[fmt_name]
    if fmt.passthrough:
        raise ValueError(f"{fmt_name} has no kernel rounding grid")
    if x.device.type == "cpu":
        routing.mark_kernel(KERNEL.name, (x,))
        return quantize_blockwise_plain(x, fmt_name, block, per_row=per_row)
    if block != _BLOCK:
        raise NotImplementedError(f"the kernel's group edge is {_BLOCK}, "
                                  f"not {block}")
    if x.dim() != 2:
        raise ValueError(f"quantize_blockwise takes a 2-D array, not "
                         f"{tuple(x.shape)}")
    dtype = cuda_operands(x)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        KERNEL.launch(x.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                      dtype, int(per_row), fmt.max_value, fmt.emin,
                      fmt.mbits, stream_ptr(x), operands=(x,))
    return y
