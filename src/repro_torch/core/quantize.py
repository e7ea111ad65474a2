"""Scaled quantize-dequantize (QDQ) with the paper's granularities
(counterpart of ``repro.core.quantize``).

An operand is quantized by choosing ``alpha = amax / Q_max`` over a
granularity group, clipping to ``alpha * Q_max`` and rounding on the
low-bit grid (App. A, Eq. 1-7).  Granularities: ``tensor`` (one scale),
``token`` (one scale per vector along the reduction axis), ``block``
(1 x B segments along the reduction axis) and ``tile`` (B x B tiles).
All full-size intermediates stay in the input dtype; only the small
per-group scales are f32 — the reference's dtype discipline, which the
bitwise tests hold the port to.

A data-parallel step splits the token axis over ranks (``TokenSplit``,
installed by the step around its rank-local region with
:func:`splitting`).  The reference's step is the one-device function of
the global batch, so a quant group that spans the token axis must see
every rank's tokens: ``quantize_dequantize(..., token_axis=)`` names the
operand axis that runs over tokens, and inside a split a ``tensor`` group,
or a ``token`` group whose reduction axis is the token axis, all-reduces
its amax (MAX) over the data group before ``scale_from_amax``
(:func:`share_amax`).  A ``block`` / ``tile`` group along the token axis
stays local when a rank's token count is a multiple of its edge (the
groups then end on rank boundaries) and raises ``ValueError`` otherwise
(:func:`spans_ranks`).

A tensor-parallel step splits a weight's heads / ``mlp`` dim over the
model group (``ModelSplit``, installed beside the token split): a
column-parallel linear holds a block of its output features N, a
row-parallel one a block of its reduction axis K.  ``model_axis`` names
the operand axis so split; a group whose extent along it is the whole
axis (``tensor``, a ``token`` group along its reduction axis) shares its
amax (MAX over the model group), a ``block`` / ``tile`` group of edge B
stays local when a rank holds a multiple of B, and when a rank holds a
divisor of B each group spans B / n neighbouring ranks, whose partial
amaxes are all-gathered and maxed over that window
(:func:`model_span`); any other count raises ``ValueError``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import threading
from typing import Any, Optional

import torch
import torch.nn.functional as F_nn

from repro_torch.core import formats as F
from repro_torch.kernels.rounding import group_scale, pow2_floor

__all__ = ["QuantSpec", "BF16_SPEC", "qdq", "quantize_dequantize",
           "compute_scale", "scale_from_amax", "pow2_floor",
           "underflow_rate", "qdq_scope_name", "scale_logical_axes",
           "TokenSplit", "token_split", "splitting", "spans_ranks",
           "share_amax", "ModelSplit", "model_split", "split_state",
           "model_span", "share_model_amax", "window_max"]


def qdq_scope_name(spec: "QuantSpec") -> str:
    """The marker of a simulated quantize of ``spec`` (the reference's
    named-scope label): ``qdq_`` + the spec's canonical string with every
    run of non-identifier characters folded to ``_``, e.g.
    ``fp4_e2m1@block128:sr`` -> ``qdq_fp4_e2m1_block128_sr``.
    ``analysis.qlint`` keys its role-safety checks on it."""
    return "qdq_" + re.sub(r"[^0-9A-Za-z_]+", "_", spec.to_str())


def scale_logical_axes(granularity: str, reduction_axis: int, axes):
    """Logical axis names of a blocked scale tensor (the reference's scale
    placement policy), from the 2-D operand's logical (row, col) names:
    block / tile scale grids keep their operand's reduction axis (the
    per-128-group count inherits that dim's name), token / tensor scales
    drop it (replicated along it)."""
    row_l, col_l = axes
    if granularity == "tensor":
        return ()
    if granularity == "token":
        return (row_l, None) if reduction_axis == 1 else (None, col_l)
    if granularity == "block":
        return ((row_l, col_l, None) if reduction_axis == 1
                else (row_l, None, col_l))
    if granularity == "tile":
        return (row_l, None, col_l, None)
    raise ValueError(f"unknown granularity: {granularity!r}")


def scale_from_amax(amax: torch.Tensor, fmt: F.FloatFormat,
                    pow2: bool = False) -> torch.Tensor:
    """Per-group scale ``alpha = max(amax, 1e-12) / Q_max`` (Eq. 3), f32,
    true IEEE division."""
    return group_scale(amax, fmt, pow2)


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """How to quantize one matmul operand (same fields and string syntax
    as the reference's ``QuantSpec``)."""

    fmt: str = "bf16"
    granularity: str = "tensor"
    block: int = 128
    pow2_scale: bool = False
    stochastic: bool = False

    @property
    def format(self) -> F.FloatFormat:
        return F.FORMATS[self.fmt]

    @property
    def is_passthrough(self) -> bool:
        return self.format.passthrough and self.fmt != "fp16"

    def short(self) -> str:
        if self.is_passthrough:
            return self.fmt
        return f"{self.fmt}/{self.granularity}"

    def to_str(self) -> str:
        if self.is_passthrough:
            s = self.fmt
        else:
            s = f"{self.fmt}@{self.granularity}"
            if self.granularity in ("block", "tile"):
                s += str(self.block)
        if self.pow2_scale:
            s += ":pow2"
        if self.stochastic:
            s += ":sr"
        return s

    def with_fmt(self, fmt: str,
                 stochastic: Optional[bool] = None) -> "QuantSpec":
        """Same scaling spec (granularity / block / pow2), another storage
        format, as the reference's (``PrecisionPlan.demote``);
        ``stochastic`` overrides the rounding mode (None keeps it)."""
        if fmt not in F.FORMATS:
            raise ValueError(f"unknown format {fmt!r}")
        sr = self.stochastic if stochastic is None else stochastic
        out = dataclasses.replace(self, fmt=fmt, stochastic=sr)
        return self if out == self else out

    @classmethod
    def from_str(cls, s: str) -> "QuantSpec":
        head, *flags = s.split(":")
        bad = set(flags) - {"pow2", "sr"}
        if bad:
            raise ValueError(f"unknown QuantSpec flags {sorted(bad)} in {s!r}")
        pow2, sr = "pow2" in flags, "sr" in flags
        if "@" in head:
            fmt, gran = head.split("@", 1)
            m = re.fullmatch(r"([a-z]+)(\d+)?", gran)
            if not m or m.group(1) not in ("tensor", "token", "block",
                                           "tile"):
                raise ValueError(f"bad granularity {gran!r} in {s!r}")
            spec = cls(fmt, m.group(1), int(m.group(2) or 128),
                       pow2_scale=pow2, stochastic=sr)
        else:
            spec = cls(head, pow2_scale=pow2, stochastic=sr)
        if spec.fmt not in F.FORMATS:
            raise ValueError(f"unknown format {spec.fmt!r} in {s!r}")
        return spec


BF16_SPEC = QuantSpec("bf16")


def _blocked_view(x2d: torch.Tensor, granularity: str, block: int,
                  reduction_axis: int) -> torch.Tensor:
    """Zero-pad the blocked axes to a block multiple and reshape:
    block -> (rows, nb, B) [red=1] or (nb, B, cols) [red=0];
    tile -> (rb, B, cb, B); tensor/token -> x as-is."""
    rows, cols = x2d.shape
    if granularity in ("tensor", "token"):
        return x2d
    if granularity == "block":
        n = x2d.shape[reduction_axis]
        nb = -(-n // block)
        pad = nb * block - n
        if reduction_axis == 1:
            x2d = F_nn.pad(x2d, (0, pad))
            return x2d.reshape(rows, nb, block)
        x2d = F_nn.pad(x2d, (0, 0, 0, pad))
        return x2d.reshape(nb, block, cols)
    if granularity == "tile":
        rb, cb = -(-rows // block), -(-cols // block)
        x2d = F_nn.pad(x2d, (0, cb * block - cols, 0, rb * block - rows))
        return x2d.reshape(rb, block, cb, block)
    raise ValueError(f"unknown granularity: {granularity!r}")


# ---------------------------------------------------------------------------
# The token axis split over a data group
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TokenSplit:
    """A rank's share of a data-parallel step's token axis: rank
    ``index`` of ``size`` in ``group`` holds, of every operand with a
    token axis, the rows ``index * n ... (index + 1) * n`` of the global
    operand (``n`` its local count: each rank holds an equal, contiguous
    share of the global batch)."""

    group: Any
    index: int
    size: int

    def offset(self, n: int) -> int:
        """This rank's first row of a token axis it holds ``n`` of."""
        return self.index * n


@dataclasses.dataclass(frozen=True)
class ModelSplit:
    """A rank's share of a tensor-parallel step's model axis: rank
    ``index`` of ``size`` in ``group`` holds, of every model-split axis,
    the entries ``index * n ... (index + 1) * n`` (``n`` its local
    count)."""

    group: Any
    index: int
    size: int

    def offset(self, n: int) -> int:
        """This rank's first entry of a split axis it holds ``n`` of."""
        return self.index * n


_SPLIT = threading.local()


def token_split() -> Optional[TokenSplit]:
    """The token split installed on this thread (None: the whole
    batch)."""
    return getattr(_SPLIT, "value", None)


def model_split() -> Optional[ModelSplit]:
    """The model split installed on this thread (None: whole weights)."""
    return getattr(_SPLIT, "model", None)


def split_state():
    """``(token split, model split)`` of this thread, for
    ``splitting(*state)`` on another thread (autograd's)."""
    return token_split(), model_split()


@contextlib.contextmanager
def splitting(split: Optional[TokenSplit],
              model: Optional[ModelSplit] = None):
    """Install the token ``split`` and the ``model`` split on this thread
    inside the block (None: none; a split of size 1 is none)."""
    prev = split_state()
    _SPLIT.value = split if split is not None and split.size > 1 else None
    _SPLIT.model = model if model is not None and model.size > 1 else None
    try:
        yield
    finally:
        _SPLIT.value, _SPLIT.model = prev


def spans_ranks(granularity: str, block: int, tokens: int,
                along_reduction: bool) -> bool:
    """Whether a quant group's amax spans the ranks of a token split (a
    ``tensor`` group, a ``token`` group along the tokens), for an operand
    holding ``tokens`` rows of the token axis locally, the token axis
    being its reduction axis (``along_reduction``) or the other; False
    when every group is a rank's own.  A ``block`` group along the
    tokens, or a ``tile``, whose edge does not divide ``tokens``
    straddles a rank boundary: ``ValueError``."""
    if granularity == "tensor" or (granularity == "token"
                                   and along_reduction):
        return True
    if ((granularity == "tile" or (granularity == "block"
                                   and along_reduction))
            and tokens % block):
        raise ValueError(
            f"a {granularity}{block} quant group along the token axis "
            f"straddles a data-parallel rank boundary: each rank holds "
            f"{tokens} token rows, not a multiple of {block} (make the "
            "per-rank batch x sequence a multiple of the group edge)")
    return False


def share_amax(amax: torch.Tensor, split: TokenSplit) -> torch.Tensor:
    """The elementwise max of ``amax`` over the split's group (f32 on the
    wire, exact for the input dtypes), in ``amax``'s dtype; recorded under
    the tag ``amax``."""
    from repro_torch.distributed import comms
    words = amax.to(torch.float32, copy=True)
    comms.all_reduce(words, "max", split.group, tag="amax")
    return words.to(amax.dtype)


def model_span(granularity: str, block: int, n: int,
               along_reduction: bool,
               ranks: Optional[int] = None) -> Optional[str]:
    """How a quant group meets a model-split axis that a rank holds ``n``
    entries of (the operand's reduction axis, or the other) over
    ``ranks`` ranks: ``"share"`` when the group runs along the whole
    axis (a ``tensor`` group, a ``token`` group along its reduction axis,
    or a ``block`` / ``tile`` group whose edge covers the whole axis of
    ``n * ranks``: mamba2's 48 ``in_dt`` heads, 24 a rank), ``"window"``
    when a ``block`` / ``tile`` group of edge ``block`` spans ``block /
    n`` ranks (``n`` divides it), None when every group is a rank's own;
    any other count raises ``ValueError``."""
    if granularity == "tensor" or (granularity == "token"
                                   and along_reduction):
        return "share"
    if granularity == "tile" or (granularity == "block"
                                 and along_reduction):
        if n % block == 0:
            return None
        if block % n == 0:
            return "window"
        if ranks is not None and n * ranks <= block:
            return "share"
        raise ValueError(
            f"a {granularity}{block} quant group along a model-split axis: "
            f"each rank holds {n} of it, neither a divisor nor a multiple "
            f"of {block} (choose a model axis that leaves each rank a "
            "divisor or a multiple of the group edge)")
    return None


def window_max(words: torch.Tensor, split: ModelSplit, n: int,
               block: int) -> torch.Tensor:
    """Each rank's partial amaxes (``words``, in place; any dtype that
    orders as the floats do) maxed over the window of ``block / n``
    neighbouring ranks whose entries make up its groups: an all-gather
    over the model group, tag ``amax_model``."""
    from repro_torch.distributed import comms
    w = block // n
    parts = comms.all_gather(words, split.group, tag="amax_model")
    first = (split.index // w) * w
    words.copy_(parts[first:first + w].amax(dim=0))
    return words


def share_model_amax(amax: torch.Tensor, split: ModelSplit, kind: str,
                     n: int, block: int) -> torch.Tensor:
    """The amax of groups that meet the model split as ``kind``
    (``model_span``): MAX all-reduced over the model group (``share``)
    or maxed over each group's window of ranks (``window``), f32 on the
    wire, tag ``amax_model``; in ``amax``'s dtype."""
    from repro_torch.distributed import comms
    words = amax.to(torch.float32, copy=True).contiguous()
    if kind == "share":
        comms.all_reduce(words, "max", split.group, tag="amax_model")
    else:
        window_max(words, split, n, block)
    return words.to(amax.dtype)


def _group_amax(xb: torch.Tensor, granularity: str,
                reduction_axis: int) -> torch.Tensor:
    mag = xb.abs()  # amax in the input dtype (exact)
    if granularity == "tensor":
        return mag.amax()
    if granularity == "token":
        return mag.amax(dim=reduction_axis, keepdim=True)
    if granularity == "block":
        return mag.amax(dim=2 if reduction_axis == 1 else 1, keepdim=True)
    return mag.amax(dim=(1, 3), keepdim=True)


def compute_scale(x2d: torch.Tensor, spec: QuantSpec,
                  reduction_axis: int) -> torch.Tensor:
    """Per-group f32 scale in blocked layout (broadcastable against the
    blocked view of ``x2d``)."""
    xb = _blocked_view(x2d, spec.granularity, spec.block, reduction_axis)
    amax = _group_amax(xb, spec.granularity, reduction_axis)
    return scale_from_amax(amax, spec.format, spec.pow2_scale)


def quantize_dequantize(x2d: torch.Tensor, spec: QuantSpec,
                        reduction_axis: int, *,
                        generator: Optional[torch.Generator] = None,
                        token_axis: Optional[int] = None,
                        model_axis: Optional[int] = None) -> torch.Tensor:
    """Simulated low-precision representation of ``x2d`` (Eq. 1-7), in
    ``x2d``'s dtype.  ``generator`` feeds stochastic specs.
    ``token_axis``: the axis of ``x2d`` that runs over tokens (None: a
    weight); inside a :func:`splitting` region a group spanning the
    tokens shares its amax across the data group (module docstring).
    ``model_axis``: the axis split over the model group under a model
    split (None: none); a group meeting it shares its amax there."""
    if spec.is_passthrough:
        return x2d
    fmt = spec.format
    if spec.fmt == "fp16":
        return F.round_to_format(x2d, fmt)
    rows, cols = x2d.shape
    xb = _blocked_view(x2d, spec.granularity, spec.block, reduction_axis)
    amax = _group_amax(xb, spec.granularity, reduction_axis)
    split = token_split() if token_axis is not None else None
    if split is not None and spans_ranks(
            spec.granularity, spec.block, x2d.shape[token_axis],
            token_axis == reduction_axis):
        amax = share_amax(amax, split)
    msplit = model_split() if model_axis is not None else None
    if msplit is not None:
        n = x2d.shape[model_axis]
        kind = model_span(spec.granularity, spec.block, n,
                          model_axis == reduction_axis, msplit.size)
        if kind is not None:
            amax = share_model_amax(amax, msplit, kind, n, spec.block)
    scale = scale_from_amax(amax, fmt, spec.pow2_scale).to(x2d.dtype)
    gen = generator if spec.stochastic else None
    y = F.round_to_format(xb / scale, fmt, generator=gen) * scale
    if spec.granularity == "block" and reduction_axis == 1:
        y = y.reshape(rows, -1)
    elif spec.granularity == "block":
        y = y.reshape(-1, cols)
    elif spec.granularity == "tile":
        y = y.reshape(y.shape[0] * y.shape[1], y.shape[2] * y.shape[3])
    return y[:rows, :cols].to(x2d.dtype)


qdq = quantize_dequantize


def underflow_rate(x: torch.Tensor, spec: QuantSpec,
                   reduction_axis: int = -1) -> torch.Tensor:
    """Fraction of nonzero inputs that quantize to exactly zero (the
    Fig. 1(b) diagnostic), round to nearest."""
    x2d = x.reshape(-1, x.shape[-1])
    y = quantize_dequantize(x2d, spec, reduction_axis % 2)
    nonzero = x2d.abs() > 0
    under = nonzero & (y == 0)
    return under.sum() / torch.clamp(nonzero.sum(), min=1)
