"""Public kernel entry points (counterpart of ``repro.kernels.ops``):
``pallas_qmm`` (the quantized matmul), ``fp4_matmul`` (its historical
forward-only form), ``quantize_blockwise`` (the standalone QDQ) and
``flash_attention`` (the differentiable attention core).

The reference pads every operand to multiples of 128 and slices the
result back.  The port's kernels mask the ragged edges instead, which
gives the same values: zero padding adds nothing to a dot and leaves
every group's amax unchanged, padded rows and columns are exactly the
ones sliced away, and the stats epilogue counts only elements inside the
operand, as the reference's ``real_dims`` masking does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import routing
from repro_torch.core.quantize import (QuantSpec, model_span,
                                       model_split, spans_ranks,
                                       token_split, window_max)
from repro_torch.distributed import comms
from repro_torch.kernels import quantize as _q
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.fp4_matmul import fused_qmm, resolve_pipeline
from repro_torch.kernels.rounding import fold_seed

__all__ = ["pallas_qmm", "fp4_matmul", "quantize_blockwise",
           "flash_attention"]


def fp4_matmul(x: torch.Tensor, w: torch.Tensor, *,
               x_fmt: str = "fp4_e2m1", w_fmt: str = "fp4_e2m1",
               block: int = 128) -> torch.Tensor:
    """``Q_block(x) @ Q_tile(w)`` (the paper's FFN forward matmul), any
    shapes (the kernels mask the ragged edges, which equals the
    reference's padding sliced back); group edge 128 only."""
    if block != 128:
        raise NotImplementedError(f"the kernels' group edge is 128, not "
                                  f"{block}")
    return fused_qmm(x, w, a_mode="block", b_mode="tile", a_fmt=x_fmt,
                     b_fmt=w_fmt)


def _split_args(side: str, x: torch.Tensor, trans: bool, mode: str,
                tokens: Optional[int], model: Optional[int]) -> dict:
    """``fused_qmm``'s split arguments of one operand whose effective
    axis ``tokens`` (of A' or B') runs over the tokens of the installed
    token split and whose effective axis ``model`` is split over the
    model group (None: not split): the SR origin of its element (0, 0) in
    the global operand and, for groups that meet a split, the amax's
    reduction (``amax_reduce_*``): a MAX all-reduce over the data group
    (tag ``amax``) and over the model group (tag ``amax_model``), or the
    window max over the ranks a straddling block / tile group spans
    (``core.quantize.model_span``)."""
    rows, cols = x.shape[-2:]
    eff = (cols, rows) if trans else (rows, cols)
    origin, reducers = [0, 0], []
    for axis, split, data in ((tokens, token_split(), True),
                              (model, model_split(), False)):
        if axis is None or split is None:
            continue
        n = eff[axis]
        # quant orientation: A' itself, B'^T (its reduction K on axis 1)
        q_axis = axis if side == "a" else 1 - axis
        origin[q_axis] += split.offset(n)
        if data:
            if spans_ranks(mode, 128, n, q_axis == 1):
                reducers.append(lambda w, g=split.group: comms.all_reduce(
                    w, "max", g, tag="amax"))
            continue
        kind = model_span(mode, 128, n, q_axis == 1, split.size)
        if kind == "share":
            reducers.append(lambda w, g=split.group: comms.all_reduce(
                w, "max", g, tag="amax_model"))
        elif kind == "window":
            reducers.append(lambda w, sp=split, n=n: window_max(
                w, sp, n, 128))
    out = {f"sr_origin_{side}": tuple(origin)}
    if reducers:
        def reduce(words):
            for fn in reducers:
                fn(words)
            return words
        out[f"amax_reduce_{side}"] = reduce
    return out


def pallas_qmm(a: torch.Tensor, b: torch.Tensor, spec_a: QuantSpec,
               spec_b: QuantSpec, *, mode_a: str, mode_b: str,
               trans_a: bool = False, trans_b: bool = False,
               key_data=None, salt: int = 0,
               pipeline: Optional[str] = None,
               bm: Optional[int] = None, bn: Optional[int] = None,
               bk: Optional[int] = None, collect_stats: bool = False,
               role: Optional[str] = None, census=None,
               tokens=(None, None), model=(None, None)):
    """Per-role quantized matmul ``Q(A') @ Q(B')`` through the fused
    pipeline (``mode_*`` from ``core.qlinear.kernel_quant_mode``).  The
    name is the reference's; here it runs the CUDA kernels.  3-D
    operands are a batch of pairs (the MoE experts), one census event
    and one batched launch a kernel.

    Stochastic specs draw their noise from seeds folded out of
    ``key_data`` (raw uint32[2] key material) and ``salt`` (0 fwd, 2
    dgrad, 4 wgrad), operand index 0 for A and 1 for B.  With
    ``collect_stats`` returns ``(y, (stats_a, stats_b))``, raw stats
    vectors (``fp4_matmul.finalize_quant_stats`` reduces them).
    ``pipeline`` / ``bm`` / ``bn`` / ``bk`` pass straight through to
    ``fused_qmm`` (None: the default pipeline, the tuning table's tiles).

    ``census`` (``(log, (layer, class))`` from ``core.qlinear``) records
    the call as a ``pallas`` route event of ``role`` in that log, with
    the modes, the pipeline it resolves to and the SR it arms.

    ``tokens``: for A' and B', the effective axis that runs over tokens
    (None: a weight).  Inside a data-parallel split
    (``core.quantize.splitting``) such an operand keys its SR noise by
    its global rows and shares a token-spanning group's amax across the
    data group; a block / tile group straddling a rank boundary raises
    ``ValueError``.  ``model``: for A' and B', the effective axis split
    over the model group (``core.qlinear.ROLE_MODEL``): inside a model
    split the operand keys its SR noise by its global columns and shares
    the amax of a group meeting the split across the ranks it spans."""
    a_sr = spec_a.stochastic and mode_a != "pass"
    b_sr = spec_b.stochastic and mode_b != "pass"
    if census is not None:
        routing.record(
            role or "?", "pallas", spec_a.to_str(), spec_b.to_str(),
            mode_a=mode_a, mode_b=mode_b,
            pipeline=resolve_pipeline(pipeline, mode_a, mode_b),
            sr_a=a_sr and key_data is not None,
            sr_b=b_sr and key_data is not None, cell=census[1],
            log=census[0])
    if (a_sr or b_sr) and key_data is None:
        raise ValueError("a stochastic spec needs key_data")
    kw = {}
    if token_split() is not None or model_split() is not None:
        for side, x, trans, mode, t_axis, m_axis in (
                ("a", a, trans_a, mode_a, tokens[0], model[0]),
                ("b", b, trans_b, mode_b, tokens[1], model[1])):
            if (t_axis is not None or m_axis is not None) \
                    and mode != "pass":
                kw.update(_split_args(side, x, trans, mode, t_axis,
                                      m_axis))
    return fused_qmm(
        a, b, a_mode=mode_a, b_mode=mode_b, a_fmt=spec_a.fmt,
        b_fmt=spec_b.fmt, a_pow2=spec_a.pow2_scale,
        b_pow2=spec_b.pow2_scale, a_sr=a_sr, b_sr=b_sr,
        seed_a=fold_seed(key_data, salt, 0) if a_sr else None,
        seed_b=fold_seed(key_data, salt, 1) if b_sr else None,
        trans_a=trans_a, trans_b=trans_b, pipeline=pipeline, bm=bm, bn=bn,
        bk=bk, collect_stats=collect_stats, **kw)


def quantize_blockwise(x: torch.Tensor, fmt_name: str = "fp4_e2m1",
                       block: int = 128, *,
                       per_row: bool = False) -> torch.Tensor:
    """Tilewise QDQ of a 2-D array of any shape (the kernel masks the
    ragged edge, which equals the reference's padding sliced back)."""
    return _q.quantize_blockwise(x, fmt_name, block, per_row=per_row)


class _Flash(torch.autograd.Function):
    """(B, S, H, D) attention: the flash kernel forward; the backward
    recomputes through ``chunked_attention`` under autograd, as the
    reference's ``_flash_bwd`` takes the vjp of ``chunked_attention``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, chunk):
        b, s, h, d = q.shape
        kvh = k.shape[2]

        def heads_first(t, n):       # (B, S, n, D) -> (B*n, S, D)
            return t.transpose(1, 2).reshape(b * n, s, d).contiguous()
        o = flash_attention_fwd(heads_first(q, h), heads_first(k, kvh),
                                heads_first(v, kvh), causal=causal)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.chunk = causal, chunk
        return o.reshape(b, h, s, d).transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.attention import chunked_attention
        q, k, v = ctx.saved_tensors
        pos = torch.arange(q.shape[1], dtype=torch.int32, device=q.device)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = chunked_attention(*leaves, pos, pos, causal=ctx.causal,
                                    chunk=ctx.chunk)
            dq, dk, dv = torch.autograd.grad(out, leaves, g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, chunk: int = 1024) -> torch.Tensor:
    """Differentiable attention, q (B, S, H, D), k / v (B, S, KVH, D):
    the flash kernel forward (the plain version on CPU tensors), the
    chunked backward; ``chunk`` is the backward's KV chunk."""
    return _Flash.apply(q, k, v, causal, chunk)
