"""Quantized linear with per-role precision (counterpart of
``repro.core.qlinear``).

``qlinear(x, w, recipe, impl=...)`` runs ``y = Q(x) @ Q(w)`` with the
recipe's forward specs; under autograd its backward runs the recipe's two
backward matmuls, each quantizing its operands along its own reduction
axis, and passes the gradients on by straight-through estimation:

    dgrad  dx = Q(g) @ Q(w^T)   (``dgrad_g`` x ``dgrad_w``, reduction N)
    wgrad  dw = Q(x^T) @ Q(g)   (``wgrad_x`` x ``wgrad_g``, reduction M)

``dx`` comes back in x's dtype and ``dw`` in w's dtype.  ``impl`` is the
config's ``linear_impl``:

* ``"qdq"`` — unfused QDQ then a matmul in the input dtype (``dot_qdq``);
* ``"pallas"`` / ``"pallas_two_pass"`` — the fused pipeline of
  ``kernels.fp4_matmul`` (the hand-written CUDA kernels), streaming by
  default or pinned to the two-pass pipeline.  A spec the kernels cannot
  realize (``kernel_unsupported_reason``: a block other than 128, fp16)
  takes ``dot_qdq`` on any device, the reference's documented fallback,
  recorded in the census as ``qdq_fallback`` with its reasons and, on a
  CUDA tensor, warned of once per spec pair (the census sees it only
  inside a capture); a kernel that fails to build or launch still
  raises.

``qmatmul`` also takes 3-D operands, (E, C, K) x (E, K, N): the MoE
experts' batched matmul, the counterpart of the reference's ``jax.vmap``
over its matmul.  Each role then runs the E products in one call (one
batched kernel launch under the fused impls, a loop over the experts'
QDQ products under ``"qdq"``), each expert quantized on its own and
every expert drawing the same SR noise (the reference vmaps one key),
and records one census event, as the reference's vmap traces its matmul
once.

A ``PackedTensor`` weight takes ``packed_linear``: the quantize-once panel
is expanded (bitwise equal to the training QDQ) and fed to the matmul as a
pass-mode operand, so only the activations are quantized per call; it is
forward only (serving).

Stochastic-rounding specs draw their noise from the zero key (the model
passes no key, so the reference's ``qlinear`` uses ``_zero_key()`` for
every call) salted per role: 0 fwd, 2 dgrad, 4 wgrad.  The kernels use
the counter hash of ``kernels.rounding`` (bitwise the reference's
interpret-mode noise); the ``"qdq"`` impl draws from a ``torch.Generator``
seeded from the same folded seed, equal to the reference's ``jax.random``
stream only in distribution.

Data parallelism (``core.quantize.TokenSplit``): inside a split the
rows of ``x`` and ``g`` are a rank's share of the global batch's tokens.
Each role tells the quantize layer which operand axis runs over tokens
(``ROLE_TOKENS``, the counterpart of the reference's logical axes
``axes_a=(k, row)``): the rows of fwd's ``x`` and dgrad's ``g``, the
reduction axis of both wgrad operands.  A group spanning the tokens then
shares its amax across the data group, and the kernels key their SR
noise by the global rows, so the split step quantizes as one process
does.  ``_QMatmul`` keeps the forward's split for its backward, which
autograd may run on a thread of its own.

Tensor parallelism (``core.quantize.ModelSplit``, the Megatron layout):
``qlinear(..., tp="col")`` holds a block of the weight's output features
N, ``tp="row"`` a block of its reduction axis K.  Each role names the
operand axes so split (``ROLE_MODEL``): a group meeting the split shares
its amax over the model group (a ``block`` / ``tile`` group a rank holds
part of is maxed over the ranks it spans) and the kernels key their SR
noise by the global columns, so each rank's operands are one process's
slices.  A row-parallel output is the sum of the ranks' partial products
(all-reduced in f32 over the model group, tag ``tp_fwd``); a
column-parallel input's cotangent is the sum of the ranks' partial
``dx`` (tag ``tp_bwd``); a statistic over split columns (the mamba
mixer's gated norm) is summed both ways (``model_stat_sum``, tag
``tp_norm``).  With no model split installed ``tp`` is
ignored.

Telemetry (``telemetry.collect``): with a collector installed, each
quantized linear records its forward-side operand stats (under
``"pallas"`` the fwd_x / fwd_w slots come from the kernels' stats
epilogue, ``pallas_qmatmul_stats``) and wraps its output in ``grad_tap``.

Routing census (``core.routing``): with a log installed, each matmul role
records its route where the reference's does (``dot`` for a passthrough
recipe, ``packed_dot`` for a passthrough serving activation, ``qdq`` /
``qdq_fallback`` in ``dot_qdq``, ``pallas`` in ``kernels.ops.pallas_qmm``).
``_QMatmul`` keeps the forward's log and (layer, class) cell in its
context and records its backward roles into that log: autograd runs a
CUDA backward on its own thread, out of the forward's thread-local
scopes.
"""
from __future__ import annotations

import functools
import warnings
from typing import Optional

import torch

from repro_torch.core import routing
from repro_torch.core.packed import PackedTensor
from repro_torch.core.quantize import (BF16_SPEC, QuantSpec, model_split,
                                       qdq, qdq_scope_name, split_state,
                                       splitting, token_split)
from repro_torch.core.recipe import MatmulRecipe
from repro_torch.kernels.rounding import fold_seed
from repro_torch.telemetry import collect as telemetry

__all__ = ["qlinear", "qmatmul", "pallas_qmatmul_stats", "packed_linear",
           "dot_qdq", "kernel_quant_mode", "kernel_unsupported_reason",
           "matmul_impl", "LINEAR_IMPLS", "ZERO_KEY", "ROLE_TOKENS",
           "ROLE_MODEL", "model_grad_sum", "model_sum", "model_stat_sum"]

LINEAR_IMPLS = ("qdq", "pallas", "pallas_two_pass")
_KERNEL_BLOCK = 128
ZERO_KEY = (0, 0)   # the reference's _zero_key(): the key every layer uses
# per role, the axis of the effective operands A' and B' that runs over
# tokens (None: the weight): fwd x (M, K), dgrad g (M, N), wgrad x^T (K,
# M) and g (M, N)
ROLE_TOKENS = {"fwd": (0, None), "dgrad": (0, None), "wgrad": (1, 0)}
# per tensor-parallel layout and role, the axis of A' and of B' split over
# the model group (None: whole): a column-parallel weight holds a block of
# N (fwd w (K, N), dgrad g (M, N) and w^T (N, K), wgrad g (M, N)); a
# row-parallel one a block of K (fwd x (M, K) and w (K, N), dgrad w^T
# (N, K), wgrad x^T (K, M))
ROLE_MODEL = {"col": {"fwd": (None, 1), "dgrad": (1, 0),
                      "wgrad": (None, 1)},
              "row": {"fwd": (1, 0), "dgrad": (None, 1),
                      "wgrad": (0, None)}}


def _generator(spec: QuantSpec, salt: int, which: int, device):
    """The QDQ path's SR noise source for one operand (None for RTN)."""
    if not spec.stochastic:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(fold_seed(ZERO_KEY, salt, which) & 0xFFFFFFFF)
    return g


def _census():
    """``(log, (layer, class))`` of the routing census installed here, or
    None (the common case: one check)."""
    log = routing.active()
    if log is None:
        return None
    return log, (routing.current_layer(), routing.current_class())


def dot_qdq(a: torch.Tensor, b: torch.Tensor, spec_a: QuantSpec,
            spec_b: QuantSpec, *, trans_a: bool = False,
            trans_b: bool = False, salt: int = 0,
            role: Optional[str] = None, route: str = "qdq",
            reasons=(), census=None, tokens=(None, None),
            model=(None, None)) -> torch.Tensor:
    """QDQ both operands of ``A' @ B'`` (``A' = a.T`` under ``trans_a``,
    same for B'; reduction axes 1 and 0), then the matmul in the input
    dtype; ``salt`` seeds a stochastic spec's noise.  With a ``census``
    (``_census()``) and a ``role`` the call records one ``route`` event
    (``qdq``, or ``qdq_fallback`` with its ``reasons``).  3-D operands
    pair by pair, every pair with the same noise.  ``tokens``: the axis
    of A' and of B' that runs over tokens (``ROLE_TOKENS``); ``model``:
    the axis split over the model group (``ROLE_MODEL``)."""
    if census is not None and role is not None:
        routing.record(role, route, spec_a.to_str(), spec_b.to_str(),
                       reasons=reasons, sr_a=spec_a.stochastic,
                       sr_b=spec_b.stochastic, cell=census[1],
                       log=census[0])
    if role is not None and routing.marking():
        with routing.role_scope(role):
            for spec in (spec_a, spec_b):
                if not spec.is_passthrough:
                    routing.mark_qdq(qdq_scope_name(spec))
    if a.dim() == 3:
        return torch.stack([dot_qdq(x, y, spec_a, spec_b, trans_a=trans_a,
                                    trans_b=trans_b, salt=salt,
                                    tokens=tokens, model=model)
                            for x, y in zip(a, b)])
    return torch.matmul(
        qdq(a.T if trans_a else a, spec_a, 1,
            generator=_generator(spec_a, salt, 0, a.device),
            token_axis=tokens[0], model_axis=model[0]),
        qdq(b.T if trans_b else b, spec_b, 0,
            generator=_generator(spec_b, salt, 1, b.device),
            token_axis=tokens[1], model_axis=model[1]))


def kernel_unsupported_reason(spec: QuantSpec) -> Optional[str]:
    """Why the fused kernels cannot realize ``spec`` (the reference's
    structured ``"<code>: <detail>"`` vocabulary), or None."""
    if spec.is_passthrough:
        return None
    if spec.fmt == "fp16":
        return ("unsupported_dtype: fp16 is clip-only (no kernel "
                "rounding grid)")
    if spec.granularity in ("block", "tile"):
        if spec.block != _KERNEL_BLOCK:
            return (f"unsupported_block: {spec.granularity}{spec.block} "
                    f"(kernel group size is {_KERNEL_BLOCK})")
        return None
    if spec.granularity in ("token", "tensor"):
        return None
    return f"unsupported_granularity: {spec.granularity!r}"


def kernel_quant_mode(spec: QuantSpec) -> Optional[str]:
    """The kernels' quantization mode realizing ``spec`` (``pass`` for
    passthrough), or None when they cannot."""
    if kernel_unsupported_reason(spec) is not None:
        return None
    if spec.is_passthrough:
        return "pass"
    return spec.granularity


_FALLBACK_WARNED: set = set()


def _warn_fallback(a: torch.Tensor, spec_a: QuantSpec, spec_b: QuantSpec,
                   reasons: tuple) -> None:
    """Warn once per spec pair that a CUDA matmul took the QDQ fallback:
    outside a routing capture nothing else shows it."""
    if a.is_cuda and (spec_a, spec_b) not in _FALLBACK_WARNED:
        _FALLBACK_WARNED.add((spec_a, spec_b))
        warnings.warn(f"qdq_fallback: {spec_a.to_str()} x "
                      f"{spec_b.to_str()} runs unfused "
                      f"QDQ on the card ({'; '.join(reasons)})",
                      RuntimeWarning, stacklevel=4)


def _dot_fused(a: torch.Tensor, b: torch.Tensor, spec_a: QuantSpec,
               spec_b: QuantSpec, *, trans_a: bool = False,
               trans_b: bool = False, salt: int = 0,
               pipeline: Optional[str] = None, collect_stats: bool = False,
               role: Optional[str] = None, census=None,
               tokens=(None, None), model=(None, None)):
    """One matmul role ``Q(A') @ Q(B')`` through the fused kernels, the
    operands read in their stored layout; with ``collect_stats`` returns
    ``(y, (stats_a, stats_b))``.  A spec they cannot realize takes
    ``dot_qdq`` on any device, as the reference's (no stats; the census
    records it as ``qdq_fallback`` with its reasons)."""
    mode_a, mode_b = kernel_quant_mode(spec_a), kernel_quant_mode(spec_b)
    if mode_a is None or mode_b is None:
        reasons = tuple(f"{operand}: {why}" for operand, spec in
                        (("lhs", spec_a), ("rhs", spec_b))
                        for why in (kernel_unsupported_reason(spec),)
                        if why is not None)
        _warn_fallback(a, spec_a, spec_b, reasons)
        y = dot_qdq(a, b, spec_a, spec_b, trans_a=trans_a, trans_b=trans_b,
                    salt=salt, role=role, route="qdq_fallback",
                    reasons=reasons, census=census, tokens=tokens,
                    model=model)
        return (y, (None, None)) if collect_stats else y
    from repro_torch.kernels.ops import pallas_qmm
    with routing.role_scope(role):
        return pallas_qmm(a, b, spec_a, spec_b, mode_a=mode_a,
                          mode_b=mode_b, trans_a=trans_a, trans_b=trans_b,
                          key_data=ZERO_KEY, salt=salt, pipeline=pipeline,
                          collect_stats=collect_stats, role=role,
                          census=census, tokens=tokens, model=model)


def _check_impl(impl: str) -> Optional[str]:
    """The pipeline an impl pins (None = default), or raise."""
    if impl not in LINEAR_IMPLS:
        raise ValueError(f"unknown linear_impl {impl!r}; have "
                         f"{list(LINEAR_IMPLS)}")
    return "two_pass" if impl == "pallas_two_pass" else None


def packed_linear(x: torch.Tensor, w: PackedTensor, recipe: MatmulRecipe,
                  *, bias: Optional[torch.Tensor] = None,
                  impl: str = "qdq") -> torch.Tensor:
    """Serving linear over a quantize-once ``PackedTensor`` panel."""
    pipeline = _check_impl(impl)
    k = x.shape[-1]
    w_dq = w.dequantize().to(x.dtype)
    spec_x = recipe.fwd_x
    x2d = x.reshape(-1, k)
    census = _census()
    if spec_x.is_passthrough:
        if census is not None:
            routing.record("fwd", "packed_dot", spec_x.to_str(),
                           recipe.fwd_w.to_str())
        y = torch.matmul(x2d, w_dq)
    elif impl == "qdq":
        y = dot_qdq(x2d, w_dq, spec_x, BF16_SPEC, role="fwd",
                    census=census)
    else:
        y = _dot_fused(x2d.contiguous(), w_dq.contiguous(), spec_x,
                       BF16_SPEC, pipeline=pipeline, role="fwd",
                       census=census)
    y = y.reshape(*x.shape[:-1], w_dq.shape[-1])
    if bias is not None:
        y = y + bias
    return y


def _role(impl: str, a, b, spec_a: QuantSpec, spec_b: QuantSpec, *,
          trans_a: bool = False, trans_b: bool = False, salt: int = 0,
          collect_stats: bool = False, role: Optional[str] = None,
          census=None, tp: Optional[str] = None):
    """One matmul role under ``impl`` (stored operands, trans flags; the
    SR salt of the role); stats only under the fused impls.  ``role``
    (fwd | dgrad | wgrad) and ``census`` feed the routing census; the
    role's token axes (``ROLE_TOKENS``; none without a role) and, under
    a model split, its model-split axes (``ROLE_MODEL[tp]``) the
    quantize layer."""
    tokens = ROLE_TOKENS.get(role, (None, None))
    model = (ROLE_MODEL[tp][role] if tp is not None and role is not None
             and model_split() is not None else (None, None))
    if impl == "qdq":
        return dot_qdq(a, b, spec_a, spec_b, trans_a=trans_a,
                       trans_b=trans_b, salt=salt, role=role, census=census,
                       tokens=tokens, model=model)
    return _dot_fused(a, b, spec_a, spec_b, trans_a=trans_a,
                      trans_b=trans_b, salt=salt, pipeline=_check_impl(impl),
                      collect_stats=collect_stats, role=role, census=census,
                      tokens=tokens, model=model)


def _sum_over(t: torch.Tensor, group, tag: str,
              layer: Optional[str]) -> torch.Tensor:
    """The sum of every model rank's ``t``, added in f32 and rounded once
    to ``t``'s dtype."""
    from repro_torch.distributed import comms
    total = t.to(torch.float32, copy=True).contiguous()
    comms.all_reduce(total, "sum", group, tag=tag, layer=layer)
    return total.to(t.dtype)


class _ModelSum(torch.autograd.Function):
    """A row-parallel output: the ranks' partial products summed over the
    model group (tag ``tp_fwd``); the cotangent, the same on every rank,
    passes through."""

    @staticmethod
    def forward(ctx, y, group):
        return _sum_over(y, group, "tp_fwd", routing.current_layer())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ModelGradSum(torch.autograd.Function):
    """A column-parallel input, the same on every rank: the identity, whose
    cotangent is the sum of the ranks' partial ``dx`` over the model group
    (tag ``tp_bwd``)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.layer = group, routing.current_layer()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.contiguous(), ctx.group, "tp_bwd",
                         ctx.layer), None


def model_grad_sum(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose cotangent is summed over the model group (a
    column-parallel input, or a replicated output that each rank reads a
    part of); ``x`` itself without a model split."""
    split = model_split()
    return x if split is None else _ModelGradSum.apply(x, split.group)


def model_sum(y: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of every rank's partial ``y`` (a
    row-parallel product, tag ``tp_fwd``), its cotangent passed through;
    ``y`` itself without a model split."""
    split = model_split()
    return y if split is None else _ModelSum.apply(y, split.group)


class _ModelStatSum(torch.autograd.Function):
    """A statistic of rows split over the model group (a norm's sum of
    squares over a rank's columns): the ranks' partial sums summed in the
    forward, and the cotangent summed again in the backward, since each
    rank's cotangent of the statistic covers its own columns alone (tag
    ``tp_norm``, both ways)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.layer = group, routing.current_layer()
        return _sum_over(t, group, "tp_norm", ctx.layer)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g.contiguous(), ctx.group, "tp_norm",
                         ctx.layer), None


def model_stat_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of every rank's partial statistic
    ``t`` (f32), its cotangent summed over the group too (``model_sum``'s
    identity backward would leave each rank its own columns' share);
    ``t`` itself without a model split."""
    split = model_split()
    return t if split is None else _ModelStatSum.apply(t, split.group)


class _QMatmul(torch.autograd.Function):
    """``Q(x) @ Q(w)`` with the recipe's backward matmuls (STE).  With
    ``collect_stats`` the forward also returns its quantized operands'
    stats vectors (no gradient; None for a pass operand).  The forward
    keeps the routing census of its thread and cell, and its token split,
    for the backward."""

    @staticmethod
    def forward(ctx, x, w, recipe: MatmulRecipe, impl: str,
                collect_stats: bool, tp: Optional[str] = None):
        ctx.save_for_backward(x, w)
        ctx.recipe, ctx.impl, ctx.census = recipe, impl, _census()
        ctx.split, ctx.tp = split_state(), tp
        out = _role(impl, x, w, recipe.fwd_x, recipe.fwd_w, salt=0,
                    collect_stats=collect_stats, role="fwd",
                    census=ctx.census, tp=tp)
        if not collect_stats:
            return out
        y, stats = out
        ctx.mark_non_differentiable(*(s for s in stats if s is not None))
        return (y, *stats)

    @staticmethod
    def backward(ctx, g, *_stats_grads):
        x, w = ctx.saved_tensors
        r, g = ctx.recipe, g.contiguous()
        dx = dw = None
        # the forward's census on this (autograd's) thread, for the
        # kernel and QDQ markers of a qlint capture
        with routing.replaying(None if ctx.census is None
                               else ctx.census[0]), splitting(*ctx.split):
            if ctx.needs_input_grad[0]:
                # dgrad: dx = Q(g) @ Q(w^T), w read transposed in place
                dx = _role(ctx.impl, g, w, r.dgrad_g, r.dgrad_w,
                           trans_b=True, salt=2, role="dgrad",
                           census=ctx.census, tp=ctx.tp).to(x.dtype)
            if ctx.needs_input_grad[1]:
                # wgrad: dw = Q(x^T) @ Q(g), x read transposed in place
                dw = _role(ctx.impl, x, g, r.wgrad_x, r.wgrad_g,
                           trans_a=True, salt=4, role="wgrad",
                           census=ctx.census, tp=ctx.tp).to(w.dtype)
        return dx, dw, None, None, None, None


def qmatmul(x2d: torch.Tensor, w: torch.Tensor, recipe: MatmulRecipe, *,
            impl: str = "qdq", tp: Optional[str] = None) -> torch.Tensor:
    """``y = Q(x2d) @ Q(w)`` for a (M, K) x (K, N) pair, differentiable
    (the reference's ``qmatmul`` / ``pallas_qmatmul`` custom_vjp), or a
    batch of E pairs, (E, M, K) x (E, K, N) -> (E, M, N).  ``tp``: the
    weight's tensor-parallel layout (``col`` | ``row``; the product of a
    row-parallel pair is the rank's partial sum)."""
    _check_impl(impl)
    return _QMatmul.apply(x2d.contiguous(), w.contiguous(), recipe, impl,
                          False, tp)


def pallas_qmatmul_stats(x2d: torch.Tensor, w: torch.Tensor,
                         recipe: MatmulRecipe, tp: Optional[str] = None):
    """``qmatmul(impl="pallas")`` that also returns the forward's stats
    vectors ``(y, (stats_x, stats_w))``, from the same kernel launch that
    quantizes the operands for the product (None for a pass operand);
    ``y`` and the gradients are those of ``qmatmul``."""
    y, sx, sw = _QMatmul.apply(x2d.contiguous(), w.contiguous(), recipe,
                               "pallas", True, tp)
    return y, (sx, sw)


def matmul_impl(impl: str):
    """Resolve a ``linear_impl`` value to its matmul (the reference's
    name): ``qmatmul`` bound to that impl."""
    _check_impl(impl)
    return functools.partial(qmatmul, impl=impl)


def qlinear(x: torch.Tensor, w, recipe: MatmulRecipe, *,
            bias: Optional[torch.Tensor] = None,
            impl: str = "qdq", tp: Optional[str] = None) -> torch.Tensor:
    """Linear over the last axis of ``x``: (..., K) @ (K, N) -> (..., N),
    quantized per the recipe (forward specs now, backward specs in the
    gradient); a passthrough recipe is one plain matmul.  ``tp``: ``w``
    is the rank's block of a column- (``col``) or row-parallel (``row``)
    weight under the installed model split (module docstring; ignored
    without one); the bias, the same on every rank, is added after the
    row-parallel sum."""
    if isinstance(w, PackedTensor):
        return packed_linear(x, w, recipe, bias=bias, impl=impl)
    _check_impl(impl)
    split = model_split()
    if tp not in (None, "col", "row"):
        raise ValueError(f"unknown tensor-parallel layout {tp!r}")
    tp = tp if split is not None else None
    if tp == "col":
        x = _ModelGradSum.apply(x, split.group)
    k = x.shape[-1]
    x2d = x.reshape(-1, k)
    if recipe.is_passthrough:
        if routing.active() is not None:
            routing.record("fwd", "dot", recipe.fwd_x.to_str(),
                           recipe.fwd_w.to_str())
        y = torch.matmul(x2d, w)
    else:
        # Telemetry taps (no-ops without a collector).  Under "pallas" the
        # fwd_x / fwd_w stats come from the epilogue of the kernels that
        # feed the product; the other forward-side slots (wgrad_x,
        # dgrad_w: other orientations) are computed by tap_matmul.
        y = fused_fwd = None
        if impl == "pallas" and telemetry.active() is not None:
            ma = kernel_quant_mode(recipe.fwd_x)
            mb = kernel_quant_mode(recipe.fwd_w)
            if (ma is not None and mb is not None
                    and (ma != "pass" or mb != "pass")):
                from repro_torch.kernels.fp4_matmul import (
                    finalize_quant_stats, reduce_quant_stats)
                y, (sa, sb) = pallas_qmatmul_stats(x2d, w, recipe, tp)
                # x's rows are a rank's tokens: its stats the group's;
                # an operand split over the model group: the group's too
                tsplit = token_split()
                if tsplit is not None and sa is not None:
                    sa = reduce_quant_stats(sa, tsplit.group)
                if tp == "row" and sa is not None:
                    sa = reduce_quant_stats(sa, split.group)
                if tp is not None and sb is not None:
                    sb = reduce_quant_stats(sb, split.group)
                fused_fwd = {slot: None if s is None
                             else finalize_quant_stats(s)
                             for slot, s in (("fwd_x", sa), ("fwd_w", sb))}
        telemetry.tap_matmul(x2d, w, recipe, fused_fwd=fused_fwd, tp=tp)
        if y is None:
            y = qmatmul(x2d, w, recipe, impl=impl, tp=tp)
        y = telemetry.grad_tap(y, recipe, tp=tp)
    if tp == "row":
        y = model_sum(y)
    y = y.reshape(*x.shape[:-1], w.shape[-1])
    if bias is not None:
        y = y + bias
    return y
