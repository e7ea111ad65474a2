"""Packed low-precision tensors: quantize-once weight panels for serving
(counterpart of ``repro.core.packed``).

``PackedTensor`` holds uint8 sign-magnitude codes (top bit sign, low bits
an index into the format's non-negative grid; 4-bit formats pack two codes
per byte along the last axis) plus f32 per-(block x block) tile scales.
``pack_tensor(w, spec).dequantize() == qdq(w, spec, 1)`` bitwise, because
every grid value of a <=8-bit format is exact in bf16 and f32.

``kv_quantize``/``kv_dequantize`` are the FP8 KV-cache codec: one scale
per (token, kv-head) vector over head_dim.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch import constant
from repro_torch.core import formats as F
from repro_torch.core.quantize import (QuantSpec, _blocked_view,
                                       compute_scale, scale_from_amax)

__all__ = ["PackedTensor", "pack_tensor", "packed_nbytes", "kv_quantize",
           "kv_dequantize"]


@functools.lru_cache(maxsize=None)
def _grid_list(fmt: str) -> Tuple[float, ...]:
    return tuple(F.format_values_host(F.FORMATS[fmt]))


def _grid(fmt: str, dtype, device) -> torch.Tensor:
    """Sorted non-negative value grid of ``fmt`` (exact in bf16/f32)."""
    return constant(_grid_list(fmt), dtype, torch.device(device))


def _sign_bit(fmt: str) -> int:
    return 1 << (F.FORMATS[fmt].bits - 1)


def _pack2(fmt: str) -> bool:
    """Two codes per byte (4-bit formats only)."""
    return F.FORMATS[fmt].bits <= 4


@functools.lru_cache(maxsize=None)
def _byte_table(fmt: str) -> Tuple[Tuple[float, ...], ...]:
    """The values each of the 256 bytes decodes to: its code's grid value
    with the code's sign (-0.0 for a negative zero); two values, low
    nibble first, for a 4-bit format."""
    grid, sb = _grid_list(fmt), _sign_bit(fmt)

    def value(code):
        v = grid[code & (sb - 1)]
        return -v if code & sb else v
    if _pack2(fmt):
        return tuple((value(b & 0x0F), value(b >> 4)) for b in range(256))
    return tuple((value(b),) if b & (sb - 1) < len(grid) else (0.0,)
                 for b in range(256))


def _decode(codes: torch.Tensor, fmt: str, dtype) -> torch.Tensor:
    """uint8 codes -> values in ``dtype``: one table lookup a byte (the
    table is exact in bf16 and f32).  A 4-bit format's byte gives two
    values along the last axis."""
    table = constant(_byte_table(fmt), dtype, codes.device)
    vals = torch.nn.functional.embedding(codes.to(torch.int32), table)
    return vals.reshape(*codes.shape[:-1], -1)


@dataclasses.dataclass
class PackedTensor:
    """A low-bit weight panel: uint8 codes + per-tile f32 scales.

    Logical shape ``(..., rows, n_cols)``; ``payload`` is
    ``(..., rows, ceil(n_cols / per_byte))`` and ``scale``
    ``(..., ceil(rows/block), ceil(n_cols/block))``.  ``ddtype`` is the
    dtype quantization ran in; ``dequantize()`` returns it.
    """

    payload: torch.Tensor
    scale: torch.Tensor
    fmt: str
    block: int
    n_cols: int
    ddtype: torch.dtype

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.payload.shape[:-1]) + (self.n_cols,)

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        """Real storage bytes: packed payload + scales."""
        return (self.payload.numel() * self.payload.element_size()
                + self.scale.numel() * self.scale.element_size())

    @property
    def bits_per_param(self) -> float:
        """Storage bits per logical element, scales included."""
        return 8.0 * self.nbytes / max(self.size, 1)

    def __getitem__(self, i: int) -> "PackedTensor":
        """The ``i``-th matrix of a stacked (layers, K, N) panel."""
        return PackedTensor(self.payload[i], self.scale[i], self.fmt,
                            self.block, self.n_cols, self.ddtype)

    def to(self, device) -> "PackedTensor":
        return PackedTensor(self.payload.to(device), self.scale.to(device),
                            self.fmt, self.block, self.n_cols, self.ddtype)

    def dequantize(self, dtype=None) -> torch.Tensor:
        """Codes -> values, bitwise identical to ``qdq(w, spec, 1)``:
        each byte looks its value (two for a 4-bit format) up in the
        format's code table (the grid value with the code's sign, QDQ's
        -0.0 kept), then the per-tile rescale in the same cast order as
        QDQ."""
        dt = dtype or self.ddtype
        vals = _decode(self.payload, self.fmt, dt)
        vals = vals[..., :self.n_cols]
        lead = vals.shape[:-2]
        k, n = vals.shape[-2:]
        b = self.block
        rb, cb = -(-k // b), -(-n // b)
        vals = torch.nn.functional.pad(vals, (0, cb * b - n, 0, rb * b - k))
        vb = vals.reshape(*lead, rb, b, cb, b)
        s = self.scale.reshape(*lead, rb, 1, cb, 1).to(dt)
        y = (vb * s).reshape(*lead, rb * b, cb * b)[..., :k, :n]
        return y.to(dt)


def _encode_grid_values(q: torch.Tensor, fmt: str) -> torch.Tensor:
    """Exact grid values -> uint8 sign-magnitude codes."""
    grid = _grid(fmt, torch.float32, q.device)
    mag = q.abs().to(torch.float32).contiguous()
    idx = torch.searchsorted(grid, mag).to(torch.uint8)
    return torch.where(torch.signbit(q), idx | _sign_bit(fmt), idx)


def _pack_one(m: torch.Tensor, spec: QuantSpec):
    k, n = m.shape
    scale = compute_scale(m, spec, 1)                # (rb, 1, cb, 1)
    sc = scale.to(m.dtype)
    xb = _blocked_view(m, "tile", spec.block, 1)
    qg = F.round_to_format(xb / sc, spec.format)
    rb, bsz, cb, _ = qg.shape
    codes = _encode_grid_values(
        qg.reshape(rb * bsz, cb * bsz)[:k, :n], spec.fmt)
    if _pack2(spec.fmt):
        if n % 2:
            codes = torch.nn.functional.pad(codes, (0, 1))
        codes = codes[:, 0::2] | (codes[:, 1::2] << 4)
    return codes, scale.reshape(rb, cb)


def pack_tensor(w: torch.Tensor, spec: QuantSpec) -> PackedTensor:
    """Quantize ``w`` (..., K, N) once into a ``PackedTensor``.  Leading
    dims (stacked layers) are packed matrix by matrix, so tile blocks never
    span a layer boundary."""
    if spec.granularity != "tile":
        raise ValueError(
            f"pack_tensor packs tile-granular weights; got {spec.short()}")
    if spec.is_passthrough or F.FORMATS[spec.fmt].bits > 8:
        raise ValueError(f"{spec.fmt} is not a packable low-bit format")
    lead = w.shape[:-2]
    k, n = w.shape[-2:]
    parts = [_pack_one(m, spec) for m in w.reshape(-1, k, n)]
    payload = torch.stack([p for p, _ in parts])
    scale = torch.stack([s for _, s in parts])
    return PackedTensor(payload.reshape(*lead, *payload.shape[1:]),
                        scale.reshape(*lead, *scale.shape[1:]),
                        spec.fmt, spec.block, n, w.dtype)


def packed_nbytes(leaves) -> Tuple[int, int]:
    """(packed_bytes, packed_param_count) over the PackedTensor leaves."""
    nbytes = count = 0
    for leaf in leaves:
        if isinstance(leaf, PackedTensor):
            nbytes += leaf.nbytes
            count += leaf.size
    return nbytes, count


def kv_quantize(x: torch.Tensor, fmt: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., D) -> (uint8 codes (..., D), f32 scales (...,)): per-vector
    amax scaling over the trailing head_dim, Eq. 3 scale math."""
    f = F.FORMATS[fmt]
    if f.bits != 8:
        raise ValueError(f"kv cache packing supports 8-bit formats; "
                         f"got {fmt}")
    scale = scale_from_amax(x.abs().amax(dim=-1), f)
    sc = scale[..., None].to(x.dtype)
    qg = F.round_to_format(x / sc, f)
    return _encode_grid_values(qg, fmt), scale


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor, fmt: str,
                  dtype) -> torch.Tensor:
    """Inverse of ``kv_quantize`` into ``dtype``."""
    return _decode(codes, fmt, dtype) * scale[..., None].to(dtype)
