"""FP8 error-feedback gradient compression (counterpart of
``repro.optim.compression``).

Gradients are compressed to FP8-E4M3 with a per-tensor scale before the
cross-replica reduction, and each replica feeds its quantization error
back into the next step (Seide et al. 2014, Karimireddy et al. 2019).

Three entry points, as the reference's:
  * ``fp8_compress_grads`` — the single-device hook: per-tensor RTN QDQ
    of ``g + r`` (``core.quantize.qdq``), the error kept as the residual;
  * ``compressed_psum`` — the reduction across a ``torch.distributed``
    process group: the scale is shared (an all-reduce MAX of the f32
    amax, times ``n / fp8_max``: headroom for the sum of ``n`` codes),
    the codes travel as 1-byte ``uint8`` words (an
    all-gather), and every rank sums them in group-rank order;
  * ``compressed_reduce_dp`` — the same scheme in one process over a
    leading replica axis (the reference's GSPMD form).

The sum of codes is the reference's: it adds in FP8, in replica order,
each partial sum rounded to ``float8_e4m3fn`` (``jnp.sum`` over fp8
codes does that; an f32 sum rounded once differs).  Two e4m3 values add
exactly in f32, so ``_fp8_sum`` adds in f32 and rounds each partial sum.
Rounding is the reference's (``ml_dtypes``): to nearest even, and a
value past 464 (half way to the next binade) is NaN, where torch's own
cast saturates to 448.  So the ``n / fp8_max`` headroom, which bounds
the exact sum, does not bound the rounded partial sums: n equal codes at
the top of the range sum to NaN in both packages.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import formats as F
from repro_torch.core.quantize import QuantSpec, qdq
from repro_torch.distributed import comms
from repro_torch.tree import tree_map

__all__ = ["init_compression_state", "fp8_compress_grads",
           "compressed_psum", "compressed_psum_grads",
           "compressed_reduce_dp"]

_SPEC = QuantSpec("fp8_e4m3", "tensor")
_EPS = 1e-12
_FP8 = torch.float8_e4m3fn
# half way from e4m3fn's max (448) to the next binade step (480): the
# largest magnitude that rounds to a finite value
_F8_OVERFLOW = 464.0


def init_compression_state(grads_like, *, dp_size: int = 1) -> Any:
    """The error-feedback residuals: f32 zeros like each gradient leaf,
    with a leading replica axis of ``dp_size`` when it is > 1 (each data
    shard keeps its own residual)."""
    lead = () if dp_size <= 1 else (dp_size,)
    return tree_map(lambda g: torch.zeros(lead + tuple(g.shape),
                                          dtype=torch.float32,
                                          device=g.device), grads_like)


def _split(out) -> Tuple[Any, Any]:
    return (tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out))


def _compress_one(g: torch.Tensor, r: torch.Tensor):
    gf = g.to(torch.float32) + r
    g2d = gf.reshape(-1, gf.shape[-1]) if gf.dim() > 1 else gf.reshape(1, -1)
    q = qdq(g2d, _SPEC, 1).reshape(gf.shape)
    return q.to(g.dtype), gf - q


def fp8_compress_grads(grads, residuals) -> Tuple[Any, Any]:
    """(compressed grads, new residuals)."""
    return _split(tree_map(_compress_one, grads, residuals))


def _f32(v, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def _to_fp8(x: torch.Tensor) -> torch.Tensor:
    """f32 -> float8_e4m3fn as the reference casts: round to nearest
    even, NaN past the overflow threshold (torch's cast saturates)."""
    q = x.to(_FP8)
    over = ~(x.abs() <= _F8_OVERFLOW)      # NaN and inf too
    return torch.where(over, torch.full_like(q, float("nan")), q)


def _fp8_sum(codes: torch.Tensor) -> torch.Tensor:
    """Sum of ``codes`` (n, ...) float8 over dim 0, in index order, each
    partial sum rounded to float8 (as f32 values)."""
    acc = codes[0].to(torch.float32)
    for i in range(1, codes.shape[0]):
        acc = _to_fp8(acc + codes[i].to(torch.float32)).to(torch.float32)
    return acc


def _scale(amax: torch.Tensor, n: int) -> torch.Tensor:
    dev = amax.device
    return (torch.maximum(amax, _f32(_EPS, dev)) * _f32(n, dev)
            / _f32(F.FP8_E4M3.max_value, dev))


def compressed_psum(x: torch.Tensor, residual: torch.Tensor, group=None,
                    *, mean: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FP8 all-reduce with error feedback over ``group`` (a process group;
    None: the default group).

      1. fold the residual in:       gf = x + r
      2. shared scale:               s  = max_ranks(amax(gf)) * n / fp8_max
      3. codes on the wire (1 B):    q  = f8(gf / s), all-gathered
      4. sum in fp8, rank order:     tot = sum(q) * s
      5. local error feedback:       r' = gf - q * s

    Returns ``(reduced, new_residual)``: the group mean (``mean=False``:
    the sum) in ``x``'s dtype, and this rank's residual."""
    n = dist.get_world_size(group)
    gf = x.to(torch.float32) + residual
    amax = comms.all_reduce(gf.abs().max().reshape(1), "max", group,
                            tag="scale")[0]
    s = _scale(amax, n)
    q = _to_fp8(gf / s)
    deq = q.to(torch.float32) * s
    codes = comms.all_gather(q.view(torch.uint8), group, tag="grad_codes")
    tot = _fp8_sum(codes.view(_FP8)) * s
    out = tot / _f32(n, tot.device) if mean else tot
    return out.to(x.dtype), gf - deq


def compressed_psum_grads(grads, residuals, group=None) -> Tuple[Any, Any]:
    """``compressed_psum`` over a gradient tree: (mean grads, new
    residuals)."""
    return _split(tree_map(lambda g, r: compressed_psum(g, r, group),
                           grads, residuals))


def _reduce_dp_one(g: torch.Tensor, r: torch.Tensor, mean: bool):
    gf = g.to(torch.float32) + r
    n = gf.shape[0]
    s = _scale(gf.abs().max(), n)
    q = _to_fp8(gf / s)
    deq = q.to(torch.float32) * s
    tot = _fp8_sum(q) * s
    out = tot / _f32(n, tot.device) if mean else tot
    return out.to(g.dtype), gf - deq


def compressed_reduce_dp(grads_dp, residuals, *, mean: bool = True
                         ) -> Tuple[Any, Any]:
    """The scheme of ``compressed_psum`` in one process: leaves of
    ``grads_dp`` / ``residuals`` are ``(dp, *shape)``, one slice a
    replica.  Returns ``(reduced, new_residuals)``: ``reduced`` shaped
    like one slice (the mean; ``mean=False``: the sum), the residuals
    keeping the replica axis."""
    return _split(tree_map(lambda g, r: _reduce_dp_one(g, r, mean),
                           grads_dp, residuals))
