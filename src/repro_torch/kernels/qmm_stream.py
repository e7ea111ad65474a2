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
quant orientation ((M, K) for A, (N, K) for B), offset by
``sr_origin_a`` / ``sr_origin_b`` (the operand's element (0, 0) in the
global operand: a data-parallel rank's token rows draw the one-process
noise).  ``collect_stats`` adds
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

A tensor-parallel rank that holds part of a ``block`` / ``tile`` group
(a row-parallel weight's K block, or a column-parallel weight's N block,
smaller than the group edge) cannot take the group's scale from the tile
it stages.  ``amax_reduce_a`` / ``amax_reduce_b`` then split the call
in two around the caller's collective, as ``quantize_rows``' shared-amax
entry does: the amax launch writes the operand's partial amax of every
group (uint32 words, the f32 bits, (groups along the quant rows, K
groups); non-negative floats order as integers), ``amax_reduce(words)``
reduces them in place (over the ranks each group spans), and the stream
kernel reads each group's scale from the words.  A batched call (the
experts of an MoE layer whose ``d_ff`` is split inside every expert)
takes the words of every pair, (E, groups, K groups), in one amax launch
and one ``amax_reduce`` call; each pair reads its own.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import routing
from repro_torch.core.quantize import _blocked_view, _group_amax
from repro_torch.kernels.build import (CudaKernel, batch_of, check_tiling,
                                       cuda_operands, effective_dims,
                                       stats_buffers, stream_ptr)
from repro_torch.kernels.quantize_rows import (MODE_CODES, fmt_args,
                                               mode_spec, seed_arg, sr_noise)
from repro_torch.kernels.ref import f32_matmul, qdq_grid_ref, \
    quant_stats_ref

__all__ = ["qmm_stream", "qmm_stream_plain", "KERNEL", "STREAM_MODES",
           "group_amax_plain"]

STREAM_MODES = ("pass", "block", "tile")

_P, _I, _F, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint
KERNEL = CudaKernel("qmm_stream",
                    [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     _F, _I, _I, _I, _F, _I, _I, _I, _I, _I,
                     _I, _U, _I, _U, _U, _U, _U, _U, _P, _P, _I, _I, _P,
                     _P, _P, _I])
GROUP = 128


def group_amax_plain(xq: torch.Tensor, mode: str) -> torch.Tensor:
    """The f32 amax of every ``mode`` group of a quant-orientation operand
    (rows, K): (rows, K groups) for ``block``, (row groups, K groups) for
    ``tile``, zero padding past the edges (the amax launch's words)."""
    amax = _group_amax(_blocked_view(xq, mode, GROUP, 1), mode, 1)
    return amax.to(torch.float32).reshape(
        amax.shape[0], amax.shape[2] if mode == "tile" else amax.shape[1])


def _blocked_amax(words: torch.Tensor, mode: str) -> torch.Tensor:
    """The (groups, K groups) amax in ``qdq_grid_ref``'s blocked layout."""
    g, nk = words.shape
    return (words.reshape(g, 1, nk, 1) if mode == "tile"
            else words.reshape(g, nk, 1))


def _reduced(amax: torch.Tensor, amax_reduce) -> torch.Tensor:
    """``amax`` as uint32 words (f32 bits in int32) reduced in place by
    ``amax_reduce``, read back as f32."""
    words = amax.contiguous().view(torch.int32)
    amax_reduce(words)
    return words.view(torch.float32)


def _batch_words(x: torch.Tensor, mode: str, trans: bool, amax_reduce):
    """For a batch of operands (E, ., .), stored ``x.T`` of their quant
    orientation under ``trans``: each pair's ``amax_reduce`` stand-in,
    which writes that pair's words from one ``amax_reduce`` call over
    every pair's (None each without a reduction)."""
    if amax_reduce is None:
        return [None] * x.shape[0]
    words = _reduced(torch.stack([group_amax_plain(t.T if trans else t,
                                                   mode) for t in x]),
                     amax_reduce).view(torch.int32)
    return [lambda w, mine=mine: w.copy_(mine) for mine in words]


def qmm_stream_plain(a: torch.Tensor, b: torch.Tensor, *, a_mode: str,
                     b_mode: str, a_fmt: str, b_fmt: str,
                     a_pow2: bool = False, b_pow2: bool = False,
                     trans_a: bool = False, trans_b: bool = False,
                     seed_a=None, seed_b=None, sr_origin_a=(0, 0),
                     sr_origin_b=(0, 0), collect_stats: bool = False,
                     bm: int = 128, bn: int = 128, amax_reduce_a=None,
                     amax_reduce_b=None):
    """Plain PyTorch version: unfused QDQ of both operands (SR noise of
    ``seed_a`` / ``seed_b`` when given), then an f32-accumulated product;
    with ``collect_stats`` also the stats vectors (None for a pass
    operand).  3-D operands pair by pair (no stats).  ``bm`` / ``bn`` are
    taken and ignored: a tiling never changes a value.  ``amax_reduce_*``:
    the same entry as the kernel's (module docstring)."""
    if a.dim() == 3:
        if collect_stats:
            raise ValueError("a batched product has no stats")
        # one reduction of every pair's words, as the kernel's entry
        given_a = _batch_words(a, a_mode, trans_a, amax_reduce_a)
        given_b = _batch_words(b, b_mode, not trans_b, amax_reduce_b)
        return torch.stack([qmm_stream_plain(
            x, y, a_mode=a_mode, b_mode=b_mode, a_fmt=a_fmt, b_fmt=b_fmt,
            a_pow2=a_pow2, b_pow2=b_pow2, trans_a=trans_a, trans_b=trans_b,
            seed_a=seed_a, seed_b=seed_b, sr_origin_a=sr_origin_a,
            sr_origin_b=sr_origin_b, amax_reduce_a=ga, amax_reduce_b=gb)
            for x, y, ga, gb in zip(a, b, given_a, given_b)])
    ae = a.T if trans_a else a
    bq_orient = b if trans_b else b.T          # B in quant orientation
    (m, k), n = ae.shape, bq_orient.shape[0]
    spec_a = mode_spec(a_mode, a_fmt, a_pow2)
    spec_b = mode_spec(b_mode, b_fmt, b_pow2)
    amax_a = amax_b = None
    if amax_reduce_a is not None:
        amax_a = _blocked_amax(_reduced(group_amax_plain(ae, a_mode),
                                        amax_reduce_a), a_mode)
    if amax_reduce_b is not None:
        amax_b = _blocked_amax(_reduced(group_amax_plain(bq_orient, b_mode),
                                        amax_reduce_b), b_mode)
    aq = qdq_grid_ref(ae, spec_a, 1,
                      sr_noise(m, k, seed_a, a.device, sr_origin_a), amax_a)
    bq = qdq_grid_ref(bq_orient, spec_b, 1,
                      sr_noise(n, k, seed_b, b.device, sr_origin_b), amax_b)
    y = f32_matmul(aq, bq.T, a.dtype)
    if not collect_stats:
        return y
    return y, tuple(None if mode == "pass" else
                    quant_stats_ref(x, q, spec, amax)
                    for mode, x, q, spec, amax in (
                        (a_mode, ae, aq, spec_a, amax_a),
                        (b_mode, bq_orient, bq, spec_b, amax_b)))


def qmm_stream(a: torch.Tensor, b: torch.Tensor, *, a_mode: str,
               b_mode: str, a_fmt: str, b_fmt: str, a_pow2: bool = False,
               b_pow2: bool = False, trans_a: bool = False,
               trans_b: bool = False, a_sr: bool = False,
               b_sr: bool = False, seed_a=None, seed_b=None,
               sr_origin_a=(0, 0), sr_origin_b=(0, 0),
               collect_stats: bool = False, bm: int = 128, bn: int = 128,
               amax_reduce_a=None, amax_reduce_b=None):
    """``Q(A') @ Q(B')``, or ``(y, (stats_a, stats_b))`` with
    ``collect_stats`` (None for a pass operand); CUDA tensors launch the
    kernel (and, with stats, the two fold kernels) at tiling (bm, bn),
    CPU tensors take the plain version.  ``amax_reduce_a`` /
    ``amax_reduce_b`` (a block / tile operand): the group amaxes reduced
    by the caller between an amax launch and the stream launch, every
    pair's in one call (module docstring)."""
    check_tiling(bm, bn)
    for mode in (a_mode, b_mode):
        if mode not in STREAM_MODES:
            raise ValueError(f"the stream pipeline takes {STREAM_MODES}, "
                             f"not {mode!r}")
    for mode, fn in ((a_mode, amax_reduce_a), (b_mode, amax_reduce_b)):
        if fn is not None and mode == "pass":
            raise ValueError("amax_reduce takes a block / tile operand, "
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
                                seed_b=seed_b, sr_origin_a=sr_origin_a,
                                sr_origin_b=sr_origin_b,
                                collect_stats=collect_stats,
                                amax_reduce_a=amax_reduce_a,
                                amax_reduce_b=amax_reduce_b)
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
    # the shared amaxes' words: zeroed, one a group, the amax launch's
    n_ks = -(-k // GROUP)
    words = [None if fn is None else torch.zeros(
        (*a.shape[:-2], -(-rows // GROUP) if mode == "tile" else rows,
         n_ks), dtype=torch.int32, device=a.device)
        for fn, mode, rows in ((amax_reduce_a, a_mode, m),
                               (amax_reduce_b, b_mode, n))]
    n_words = sum(w is not None for w in words)

    def launch(phase, kernels, extra):
        KERNEL.launch(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                      batch_of(a), dtype, MODE_CODES[a_mode],
                      MODE_CODES[b_mode],
                      *fmt_args(a_mode, a_fmt, a_pow2),
                      *fmt_args(b_mode, b_fmt, b_pow2), int(trans_a),
                      int(trans_b), int(a_sr), seed_arg(seed_a), int(b_sr),
                      seed_arg(seed_b),
                      *(int(o) & 0xFFFFFFFF
                        for o in (*sr_origin_a, *sr_origin_b)),
                      *(ptrs if extra else (None, None)), bm, bn,
                      stream_ptr(a),
                      *(None if w is None else w.data_ptr() for w in words),
                      phase, operands=(a, b), kernels=kernels,
                      trans=trans_a or trans_b,
                      sr=extra and (a_sr or b_sr),
                      stats=extra and n_stats > 0,
                      tc=extra and KERNEL.tensor_core(dtype, m),
                      batched=a.dim() == 3, tiles=(bm, bn) if extra
                      else None)

    with torch.cuda.device(a.device):
        if not n_words:
            launch(0, 1 + 2 * (n_stats > 0), True)
        else:
            # one amax kernel an operand, the caller's reductions, then
            # the stream kernel reading the words
            launch(1, n_words, False)
            for fn, w in zip((amax_reduce_a, amax_reduce_b), words):
                if w is not None:
                    fn(w)
            launch(2, 1 + 2 * (n_stats > 0), True)
    if not collect_stats:
        return c
    return c, tuple(None if s is None else s[-1] for s in stats)
