"""``quantize_rows``: the quantize pass (phase 1 of the two-pass
pipeline) — CUDA kernel ``csrc/quantize_rows.cu``, replacing
``repro/kernels/fp4_matmul.py::_quant_kernel``.

QDQ of a 2-D operand in quant orientation (rows, reduction), groups along
axis 1: ``block`` (1 x 128), ``tile`` (128 x 128), ``token`` (one row) or
``tensor`` (everything), round-to-nearest-even or, under ``sr``,
stochastic rounding with the counter-hash noise of ``seed``.  Under
``trans`` the stored operand is the transpose of the quant orientation and
is read in place; under ``emit_trans`` the result is written transposed.
``collect_stats`` adds the stats epilogue's (8,) f32 vector
(``fp4_matmul.finalize_quant_stats`` reduces it).  A 3-D operand (E,
., .) quantizes E operands in one batched launch, each as it would be
alone (the MoE experts; no stats).  The plain version
``quantize_rows_plain`` computes the same bits with PyTorch ops; the
wrapper takes it only for a tensor on the CPU.

A data-parallel rank holds a share of the token axis (``core.quantize.
TokenSplit``).  ``sr_origin`` is the operand's element (0, 0) in the
global operand, in quant orientation: the SR noise is keyed by the global
coordinates, so a rank draws the one-process noise of its rows.
``amax_reduce`` (tensor and token groups: a data split's groups along
the tokens, a model split's along a row-parallel K) splits the launch in
two around the caller's reduction: the amax kernel writes each group's
amax as uint32 words (the f32 bits; non-negative floats order as
integers), ``amax_reduce(words)`` all-reduces them in place (MAX, over
the ranks), and the QDQ kernel reads them.  The plain version takes the
same entry.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import routing
from repro_torch.core.formats import FORMATS
from repro_torch.core.quantize import QuantSpec, _group_amax
from repro_torch.kernels.build import (CudaKernel, batch_of, cuda_operands,
                                       stats_buffers, stream_ptr)
from repro_torch.kernels.ref import qdq_grid_ref, quant_stats_ref
from repro_torch.kernels.rounding import hash_uniform

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

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
KERNEL = CudaKernel("quantize_rows",
                    [_P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                     _P, _I, _I, _U, _U, _U, _P, _P, _P, _P])


def mode_spec(mode: str, fmt_name: str, pow2: bool) -> QuantSpec:
    """The ``QuantSpec`` a kernel mode realizes (``pass`` = bf16)."""
    if mode == "pass":
        return QuantSpec("bf16")
    return QuantSpec(fmt_name, mode, GROUP, pow2_scale=pow2)


def sr_noise(rows: int, cols: int, seed, device,
             origin=(0, 0)) -> torch.Tensor:
    """The kernels' SR noise of a (rows, cols) quant-orientation operand
    whose element (0, 0) lies at ``origin``, or None when ``seed`` is
    None (round to nearest)."""
    if seed is None:
        return None
    return hash_uniform((rows, cols), seed, *origin, device=device)


def cross_block(mode: str, trans: bool) -> bool:
    """Whether a launch's groups span blocks (tensor groups, transposed
    token groups): their amax is reduced by a kernel of its own, and only
    they take ``amax_reduce``."""
    return mode == "tensor" or (mode == "token" and trans)


def _check_reduce(mode: str, trans: bool, amax_reduce) -> None:
    if amax_reduce is not None and mode not in ("token", "tensor"):
        raise ValueError(f"amax_reduce takes token and tensor groups, not "
                         f"{mode!r}")


def _words(amax: torch.Tensor, amax_reduce) -> torch.Tensor:
    """The kernel's amax words of ``amax`` (f32 bits as int32, flat as
    the kernel's scratch: operand-major, then quant row), reduced by
    ``amax_reduce`` in place, read back as f32 in ``amax``'s shape."""
    words = amax.to(torch.float32, copy=True).reshape(-1).view(torch.int32)
    amax_reduce(words)
    return words.view(torch.float32).reshape(amax.shape)


def quantize_rows_plain(x: torch.Tensor, *, mode: str, fmt_name: str,
                        pow2: bool = False, trans: bool = False,
                        emit_trans: bool = False, seed=None,
                        sr_origin=(0, 0), amax_reduce=None,
                        collect_stats: bool = False, amax=None):
    """Plain PyTorch version of the kernel (same bits, stats included);
    ``seed`` None rounds to nearest; a 3-D operand operand by operand
    (no stats), each with the same noise (one ``amax_reduce`` call for
    the batch, as the kernel's).  ``amax``: the groups' amax given (the
    blocked layout ``core.quantize._group_amax`` gives)."""
    _check_reduce(mode, trans, amax_reduce)
    spec = mode_spec(mode, fmt_name, pow2)
    if x.dim() == 3:
        if collect_stats:
            raise ValueError("a batched quantize pass has no stats")
        amaxes = [None] * x.shape[0]
        if amax_reduce is not None:
            amaxes = _words(torch.stack([_group_amax(
                t.T if trans else t, spec.granularity, 1) for t in x]),
                amax_reduce).unbind(0)
        return torch.stack([quantize_rows_plain(
            t, mode=mode, fmt_name=fmt_name, pow2=pow2, trans=trans,
            emit_trans=emit_trans, seed=seed, sr_origin=sr_origin, amax=a)
            for t, a in zip(x, amaxes)])
    xe = x.T if trans else x
    if amax_reduce is not None:
        amax = _words(_group_amax(xe, spec.granularity, 1), amax_reduce)
    q = qdq_grid_ref(xe, spec, 1,
                     sr_noise(*xe.shape, seed, x.device, sr_origin), amax)
    y = q.T.contiguous() if emit_trans else q
    if collect_stats:
        return y, quant_stats_ref(xe, q, spec, amax)
    return y


def quantize_rows(x: torch.Tensor, *, mode: str, fmt_name: str,
                  pow2: bool = False, trans: bool = False,
                  emit_trans: bool = False, sr: bool = False, seed=None,
                  sr_origin=(0, 0), amax_reduce=None,
                  collect_stats: bool = False):
    """QDQ of ``x`` (rows, reduction) per ``mode`` into ``fmt_name``; of
    ``x.T`` under ``trans``, read in place.  The result is (rows,
    reduction), or its transpose under ``emit_trans``; with
    ``collect_stats``, ``(result, stats)``.  ``sr`` rounds stochastically
    with the noise of ``seed`` (an int32 from ``rounding.fold_seed``),
    keyed from ``sr_origin``; ``amax_reduce`` shares the cross-block
    groups' amax (module docstring).

    A CUDA tensor launches the kernel (the stats fold is two more; the
    cross-block amax of tensor mode and of a transposed token launch
    another, a launch of its own under ``amax_reduce``); a CPU tensor
    takes the plain version.
    """
    if mode not in MODE_CODES or mode == "pass":
        raise ValueError(f"unknown quantize mode {mode!r}")
    if sr and seed is None:
        raise ValueError("stochastic rounding needs a seed")
    if collect_stats and x.dim() == 3:
        raise ValueError("a batched quantize pass has no stats")
    _check_reduce(mode, trans, amax_reduce)
    args = fmt_args(mode, fmt_name, pow2)
    seed = seed if sr else None
    if x.device.type == "cpu":
        routing.mark_kernel(KERNEL.name, (x,))
        return quantize_rows_plain(x, mode=mode, fmt_name=fmt_name,
                                   pow2=pow2, trans=trans,
                                   emit_trans=emit_trans, seed=seed,
                                   sr_origin=sr_origin,
                                   amax_reduce=amax_reduce,
                                   collect_stats=collect_stats)
    dtype = cuda_operands(x)
    batch = batch_of(x)
    rows, cols = x.shape[-2:][::-1] if trans else x.shape[-2:]
    y = torch.empty((*x.shape[:-2], *((cols, rows) if emit_trans
                                      else (rows, cols))),
                    dtype=x.dtype, device=x.device)
    stats = stats_buffers(rows, cols, x.device) if collect_stats else None
    if y.numel() == 0:
        return (y, stats[-1].zero_()) if collect_stats else y
    # the amax of a group that spans blocks (the whole tensor; a stored
    # column under trans), or that is shared, is reduced by a kernel of
    # its own into zeroed uint32s: one, or one per quant row
    spans = cross_block(mode, trans)
    scratch = (torch.zeros(batch * (rows if mode == "token" else 1),
                           dtype=torch.int32, device=x.device)
               if spans or amax_reduce is not None else None)
    ptrs = [None] * 3 if stats is None else [t.data_ptr() for t in stats]
    flags = dict(operands=(x,), trans=trans or emit_trans,
                 batched=x.dim() == 3)

    def launch(phase, kernels, extra):
        KERNEL.launch(x.data_ptr(), y.data_ptr(), rows, cols, batch, dtype,
                      MODE_CODES[mode], *args, int(trans), int(emit_trans),
                      None if scratch is None else scratch.data_ptr(),
                      phase, int(sr), seed_arg(seed),
                      *(int(o) & 0xFFFFFFFF for o in sr_origin),
                      *(ptrs if extra else [None] * 3), stream_ptr(x),
                      kernels=kernels, sr=sr and extra,
                      stats=collect_stats and extra, **flags)

    with torch.cuda.device(x.device):
        # that amax and the stats fold (two) are kernels of their own
        # beside the QDQ; a shared amax is reduced between the amax and
        # the QDQ launches
        if amax_reduce is None:
            launch(0, 1 + spans + 2 * collect_stats, True)
        else:
            launch(1, 1, False)
            amax_reduce(scratch)
            launch(2, 1 + 2 * collect_stats, True)
    return (y, stats[-1]) if collect_stats else y


def seed_arg(seed) -> int:
    """An int32 seed as the kernels' uint32 argument (0 when unused)."""
    return 0 if seed is None else int(seed) & 0xFFFFFFFF
