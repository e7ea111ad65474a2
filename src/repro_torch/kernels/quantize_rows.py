"""``quantize_rows``: the quantize pass (phase 1 of the two-pass
pipeline) — CUDA kernel ``csrc/quantize_rows.cu``, replacing
``repro/kernels/fp4_matmul.py::_quant_kernel``.

QDQ of a 2-D operand in quant orientation (rows, reduction), groups along
axis 1: ``block`` (1 x 128), ``tile`` (128 x 128), ``token`` (one row) or
``tensor`` (everything), round-to-nearest-even.  Under ``trans`` the
stored operand is the transpose of the quant orientation and is read in
place; under ``emit_trans`` the result is written transposed.  The plain
version ``quantize_rows_plain`` computes the same bits with PyTorch ops;
the wrapper takes it only for a tensor on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import FORMATS
from repro_torch.core.quantize import QuantSpec
from repro_torch.kernels.build import CudaKernel, cuda_operands, stream_ptr
from repro_torch.kernels.ref import quantize_panels_ref

__all__ = ["quantize_rows", "quantize_rows_plain", "KERNEL", "MODE_CODES",
           "fmt_args"]

MODE_CODES = {"pass": 0, "block": 1, "tile": 2, "token": 3, "tensor": 4}
GROUP = 128


def fmt_args(mode: str, fmt_name: str, pow2: bool):
    """The codec's format arguments of a launch, ``(Q_max, emin, mbits,
    pow2)``; zeros for a pass-mode operand."""
    if mode == "pass":
        return (0.0, 0, 0, 0)
    fmt = FORMATS[fmt_name]
    if fmt.passthrough:
        raise ValueError(f"{fmt_name} has no kernel rounding grid")
    return (fmt.max_value, fmt.emin, fmt.mbits, int(pow2))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("quantize_rows",
                    [_P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P,
                     _P])


def mode_spec(mode: str, fmt_name: str, pow2: bool) -> QuantSpec:
    """The ``QuantSpec`` a kernel mode realizes (``pass`` = bf16)."""
    if mode == "pass":
        return QuantSpec("bf16")
    return QuantSpec(fmt_name, mode, GROUP, pow2_scale=pow2)


def quantize_rows_plain(x: torch.Tensor, *, mode: str, fmt_name: str,
                        pow2: bool = False, trans: bool = False,
                        emit_trans: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (same bits)."""
    q = quantize_panels_ref(x, mode_spec(mode, fmt_name, pow2), trans=trans)
    return q.T.contiguous() if emit_trans else q


def quantize_rows(x: torch.Tensor, *, mode: str, fmt_name: str,
                  pow2: bool = False, trans: bool = False,
                  emit_trans: bool = False, sr: bool = False,
                  collect_stats: bool = False) -> torch.Tensor:
    """QDQ of ``x`` (rows, reduction) per ``mode`` into ``fmt_name``; of
    ``x.T`` under ``trans``, read in place.  The result is (rows,
    reduction), or its transpose under ``emit_trans``.

    A CUDA tensor launches the kernel; a CPU tensor takes the plain
    version.  Stochastic rounding and the stats epilogue are not ported
    and raise.
    """
    if sr or collect_stats:
        raise NotImplementedError(
            "quantize_rows: stochastic rounding and the stats epilogue are "
            "not ported yet")
    if mode not in MODE_CODES or mode == "pass":
        raise ValueError(f"unknown quantize mode {mode!r}")
    args = fmt_args(mode, fmt_name, pow2)
    if x.device.type == "cpu":
        return quantize_rows_plain(x, mode=mode, fmt_name=fmt_name,
                                   pow2=pow2, trans=trans,
                                   emit_trans=emit_trans)
    dtype = cuda_operands(x)
    rows, cols = (x.shape[1], x.shape[0]) if trans else x.shape
    y = torch.empty((cols, rows) if emit_trans else (rows, cols),
                    dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    scratch = (torch.zeros(1, dtype=torch.int32, device=x.device)
               if mode == "tensor" else None)
    with torch.cuda.device(x.device):
        # tensor mode is two kernels: the whole-tensor amax, then the QDQ
        KERNEL.launch(x.data_ptr(), y.data_ptr(), rows, cols, dtype,
                      MODE_CODES[mode], *args, int(trans), int(emit_trans),
                      None if scratch is None else scratch.data_ptr(),
                      stream_ptr(x), kernels=2 if mode == "tensor" else 1,
                      trans=trans or emit_trans)
    return y
