"""``flash_attention_fwd``: online-softmax attention forward, causal or
not — CUDA kernel ``csrc/flash_attention.cu``, replacing
``repro/kernels/flash_attention.py::_fa_kernel``.

q (B*H, S, D), k / v (B*KVH, S, D) with ``rep = H / KVH`` (the reference
repeats K / V before the call; the kernel reads row ``bh // rep``
instead), output (B*H, S, D) in q's dtype.  The route is a function of
the dtype alone: bf16 runs the tensor-core kernel (wgmma products, P
carried as three bf16 terms), f32 the CUDA-core FMA kernel;
``KERNEL.counts()["tc"]`` counts the tensor-core launches.
``flash_attention_fwd_plain`` is the plain version: the reference's
online softmax (scores, probabilities and the running sums in f32;
128-key tiles) with each route's scores, in PyTorch ops.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.core import routing
from repro_torch.kernels.build import CudaKernel, stream_ptr

__all__ = ["flash_attention_fwd", "flash_attention_fwd_plain", "KERNEL",
           "NEG_INF"]

NEG_INF = -1e30
_TILE = 128                      # the reference's bq / bk
_SEQ_MULTIPLE = 64               # the kernel's q / KV tile
_HEAD_DIMS = (16, 32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNEL = CudaKernel("flash_attention",
                    [_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P])


def _scale(d: int) -> float:
    """``1 / sqrt(D)`` rounded to f32, as the reference's weakly typed
    scalar multiplies an f32 array."""
    return float(np.float32(1.0 / math.sqrt(d)))


def _check(q, k, v):
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"expected (BH, S, D) q and equal (BKV, S, D) k / "
                         f"v; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    bh, s, d = q.shape
    if k.shape[1:] != (s, d) or k.shape[0] == 0 or bh % k.shape[0]:
        raise ValueError(f"k / v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    return bh, s, d, bh // k.shape[0]


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True
                              ) -> torch.Tensor:
    """Plain PyTorch version: the reference kernel's online softmax over
    128-key tiles, in f32.

    The scores follow each route's arithmetic.  f32: q cast to f32 and
    scaled, then an f32 dot, as the reference (and the FMA kernel).
    bf16: the exact dot of the bf16 operands (summed in f64, far below an
    f32 ulp off), rounded once to f32, then scaled in f32.  The
    tensor-core kernel's products are exact and its f32 sums land within
    a few f32 ulps of that; the reference's own f32 order is itself off
    the true outputs by more than the card's bar at D = 128 on the card
    tests' inputs (see ``csrc/flash_attention.cu``)."""
    bh, s, d, rep = _check(q, k, v)
    kv = torch.arange(bh, device=q.device) // rep
    vf = v.index_select(0, kv).to(torch.float32)
    if q.dtype == torch.bfloat16:
        qs = q.to(torch.float64)
        ks = k.index_select(0, kv).to(torch.float64)
        post_scale = _scale(d)
    else:
        qs = q.to(torch.float32) * _scale(d)
        ks = k.index_select(0, kv).to(torch.float32)
        post_scale = None
    m = torch.full((bh, s, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, s, d), dtype=torch.float32, device=q.device)
    qpos = torch.arange(s, device=q.device)[:, None]
    tile = min(_TILE, s)
    for k0 in range(0, s, tile):
        sc = torch.matmul(qs, ks[:, k0:k0 + tile].transpose(1, 2))
        if post_scale is not None:
            sc = sc.to(torch.float32) * post_scale
        if causal:
            kpos = torch.arange(k0, k0 + sc.shape[-1], device=q.device)
            sc = torch.where(kpos[None] <= qpos, sc,
                             torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        safe_m = torch.where(m_new <= NEG_INF / 2, torch.zeros_like(m_new),
                             m_new)
        corr = torch.exp(m - safe_m) * (m > NEG_INF / 2)
        p = torch.exp(sc - safe_m)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vf[:, k0:k0 + tile])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """Attention forward over (BH, S, D), causal unless ``causal=False``
    (an encoder's).  CUDA tensors launch the kernel (S a multiple of 64,
    D in 16 / 32 / 64 / 128, contiguous and 16-byte aligned, one dtype of
    f32 / bf16); CPU tensors take the plain version."""
    bh, s, d, rep = _check(q, k, v)
    if q.device.type == "cpu":
        routing.mark_kernel(KERNEL.name, (q, k, v))
        return flash_attention_fwd_plain(q, k, v, causal=causal)
    if q.device.type != "cuda" or k.device != q.device or \
            v.device != q.device:
        raise ValueError("flash_attention_fwd runs on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention_fwd takes float32 or bfloat16 "
                        f"q / k / v of one dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if s % _SEQ_MULTIPLE or d not in _HEAD_DIMS:
        raise ValueError(f"the kernel takes S % {_SEQ_MULTIPLE} == 0 and D "
                         f"in {_HEAD_DIMS}; got S={s}, D={d}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (q, k, v)):
        raise ValueError("flash_attention_fwd takes contiguous, 16-byte "
                         "aligned q / k / v")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    dtype = 0 if q.dtype == torch.float32 else 1
    with torch.cuda.device(q.device):
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      bh, s, d, rep, _scale(d), int(causal), dtype,
                      stream_ptr(q), operands=(q, k, v),
                      tc=KERNEL.tensor_core(dtype))
    return o
