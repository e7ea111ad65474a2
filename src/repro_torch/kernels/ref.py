"""Plain PyTorch oracles for the kernels (counterpart of
``repro.kernels.ref``): unfused QDQ through the shared codec, with
injectable stochastic-rounding noise, an f32-accumulated product, and the
stats epilogue's vector in the kernels' canonical fold order.  The
kernels' plain versions are built on these.

The stats fold order (``quant_stats_ref``) is the one every kernel of the
port follows, so a kernel and its plain version agree bit for bit on all
eight lanes, at any size:

1. a *row partial* per (quant row, 128-column k-slab): the ``tree128``
   sum of the slab row's per-element terms;
2. a *slab partial* per (128-row block-row, k-slab): the ``tree128`` fold
   of its rows' partials (absent rows neutral);
3. a block-row accumulator over its k-slabs in increasing k, then the
   total over block-rows in increasing order.

Steps 2-3 keep the reference's (block-row, k-slab) structure; its
in-slab sum order is XLA's, so against JAX the float lanes (err², val²)
agree to rounding only, and counts agree exactly while they stay below
2^24.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantize import (QuantSpec, _blocked_view,
                                       _group_amax, qdq)
from repro_torch.kernels.rounding import group_scale, round_to_grid

__all__ = ["qdq_grid_ref", "f32_matmul",
           "quant_stats_ref", "quantize_blockwise_ref", "tree128",
           "STATS_WIDTH", "STATS_BIG"]

# Stats lanes: 0 clip count, 1 underflow count, 2 nonzero count, 3 sum
# err^2, 4 sum x^2, 5 min group scale, 6 max group scale, 7 element count.
STATS_WIDTH = 8
STATS_BIG = 3.0e38
_GROUP = 128


def qdq_grid_ref(x2d: torch.Tensor, spec: QuantSpec, reduction_axis: int,
                 noise: Optional[torch.Tensor] = None,
                 amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """QDQ through the shared grid codec with injectable SR noise (f32
    uniform [0, 1), the shape of ``x2d``): given the noise a kernel drew,
    this reproduces its stochastic rounding bit for bit.  ``amax``: the
    group amax to scale by (blocked layout, as ``_group_amax`` gives it)
    in place of ``x2d``'s own (a data-parallel rank's shared amax)."""
    if spec.is_passthrough or (noise is None and amax is None):
        return qdq(x2d, spec, reduction_axis)
    rows, cols = x2d.shape
    xb = _blocked_view(x2d, spec.granularity, spec.block, reduction_axis)
    nb = (None if noise is None else
          _blocked_view(noise, spec.granularity, spec.block, reduction_axis))
    if amax is None:
        amax = _group_amax(xb, spec.granularity, reduction_axis)
    scale = group_scale(amax, spec.format, spec.pow2_scale).to(x2d.dtype)
    y = round_to_grid(xb / scale, spec.format, nb) * scale
    if spec.granularity == "block" and reduction_axis == 1:
        y = y.reshape(rows, -1)
    elif spec.granularity == "block":
        y = y.reshape(-1, cols)
    elif spec.granularity == "tile":
        y = y.reshape(y.shape[0] * y.shape[1], y.shape[2] * y.shape[3])
    return y[:rows, :cols].to(x2d.dtype)


def f32_matmul(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """``a @ b`` accumulated in f32, in ``dtype``; both operands made
    contiguous first, so the product does not depend on the layout the
    operands arrive in (the plain pipelines then agree bit for bit)."""
    return torch.matmul(a.to(torch.float32).contiguous(),
                        b.to(torch.float32).contiguous()).to(dtype)


def tree128(v: torch.Tensor, dim: int, op=torch.add) -> torch.Tensor:
    """Fold 128 entries of ``v`` along ``dim`` in the kernels' warp order:
    lane l sums entries l, l+32, l+64, l+96 in turn, then a butterfly over
    the 32 lanes (xor 16, 8, 4, 2, 1)."""
    v = v.movedim(dim, -1)
    t = op(v[..., 0:32], v[..., 32:64])
    t = op(t, v[..., 64:96])
    t = op(t, v[..., 96:128])
    for w in (16, 8, 4, 2, 1):
        t = op(t[..., :w], t[..., w:2 * w])
    return t[..., 0]


def _row_slab_scales(x: torch.Tensor, spec: QuantSpec,
                     amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(rows, k-slabs) f32 scale of the group each row-slab lies in
    (``amax``: the groups' amax given, as ``qdq_grid_ref`` takes it)."""
    rows, cols = x.shape
    ks = -(-cols // _GROUP)
    if amax is None:
        xb = _blocked_view(x, spec.granularity, spec.block, 1)
        amax = _group_amax(xb, spec.granularity, 1)
    s = group_scale(amax, spec.format, spec.pow2_scale)
    if spec.granularity == "block":
        return s[..., 0]
    if spec.granularity == "tile":             # (rb, 1, cb, 1)
        return s[:, 0, :, 0].repeat_interleave(_GROUP, 0)[:rows]
    return s.expand(rows, ks)               # token (rows, 1), tensor ()


def quant_stats_ref(x: torch.Tensor, q: torch.Tensor, spec: QuantSpec,
                    amax: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The stats epilogue's (8,) f32 vector of one operand in quant
    orientation: ``x`` (rows, reduction) and its QDQ result ``q``, groups
    along axis 1 per ``spec`` (scaled by ``amax`` when given); in the
    canonical fold order above."""
    rows, cols = x.shape
    ks = -(-cols // _GROUP)
    pad = ks * _GROUP - cols
    xf = torch.nn.functional.pad(x.to(torch.float32), (0, pad))
    qf = torch.nn.functional.pad(q.to(torch.float32), (0, pad))
    xf, qf = xf.view(rows, ks, _GROUP), qf.view(rows, ks, _GROUP)
    scale = _row_slab_scales(x, spec, amax).to(torch.float32)
    thr = torch.full_like(scale, float(np.float32(
        spec.format.max_value * (1.0 + 1e-6))))
    mag = xf.abs()
    nz = mag > 0
    err = xf - qf
    terms = torch.stack([
        (mag > (scale * thr)[..., None]).to(torch.float32),
        (nz & (qf == 0)).to(torch.float32),
        nz.to(torch.float32), err * err, xf * xf], dim=-1)
    cnt = torch.clamp(cols - _GROUP * torch.arange(ks, device=x.device),
                      max=_GROUP).to(torch.float32).expand(rows, ks)
    part = torch.cat([tree128(terms, 2), scale[..., None], scale[..., None],
                      cnt[..., None]], dim=-1)          # (rows, ks, 8)
    nrb = -(-rows // _GROUP)
    neutral = torch.zeros(STATS_WIDTH, device=x.device)
    neutral[5] = STATS_BIG
    full = neutral.expand(nrb * _GROUP, ks, STATS_WIDTH).clone()
    full[:rows] = part
    full = full.view(nrb, _GROUP, ks, STATS_WIDTH)
    slab = torch.cat([tree128(full[..., :5], 1),
                      tree128(full[..., 5:6], 1, torch.minimum),
                      tree128(full[..., 6:7], 1, torch.maximum),
                      tree128(full[..., 7:8], 1)], dim=-1)  # (nrb, ks, 8)

    def fold(t):                       # sequential over dim 0
        acc = t[0]
        for i in range(1, t.shape[0]):
            nxt = acc + t[i]
            nxt[5] = torch.minimum(acc[5], t[i][5])
            nxt[6] = torch.maximum(acc[6], t[i][6])
            acc = nxt
        return acc
    return fold(torch.stack([fold(slab[r].clone()) for r in range(nrb)]))


def quantize_blockwise_ref(x: torch.Tensor, fmt_name: str,
                           block: int = 128, *,
                           per_row: bool = False) -> torch.Tensor:
    """Per-(block x block)-tile QDQ of a 2-D array in f32 math, or per
    (1 x block) along each row with ``per_row``; result in x's dtype."""
    spec = QuantSpec(fmt_name, "block" if per_row else "tile", block)
    return qdq(x.to(torch.float32), spec, 1).to(x.dtype)
