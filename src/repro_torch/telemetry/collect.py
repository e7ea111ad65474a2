"""Quantization telemetry taps (counterpart of
``repro.telemetry.collect``).

The taps sit in ``core.qlinear.qlinear`` and are driven by a thread-local
*collector* that the train step installs around the loss; with no
collector every hook is a no-op and the step is exactly the
telemetry-free one.

Two channels carry the statistics out:

* **Forward-side stats** (the operand slots whose tensors exist in the
  forward: fwd_x, fwd_w, wgrad_x, dgrad_w).  ``models.stack`` opens a
  :func:`layer_frame` per layer; each quantized linear pushes
  ``{scope}/mm{j}/{slot}/{stat}`` scalars into the current frame and the
  stack drains it into the loss metrics as ``tel/l{i:02d}/...``.  Taps
  outside any layer (the LM head) land in the root frame, drained as
  ``tel/...``.
* **Gradient-side stats** (dgrad_g / wgrad_g: the cotangent exists only
  in the backward).  :func:`grad_tap` wraps each quantized linear's output
  in an identity ``torch.autograd.Function`` whose backward writes the
  incoming cotangent's stats into its layer's row of a zero *probe*, one
  ``(n_layers + 1, PROBE_SIZE)`` leaf per module class (the last row is
  for taps outside the stack, the LM head).  The train step takes the
  gradient of the loss with respect to the probes; the trailing
  tap-count slot keeps the rows self-normalizing when microbatches add up.

Statistics per operand slot (f32): ``clip`` (fraction above the group's
clip point), ``underflow`` (fraction of nonzeros that quantize to 0, the
Fig. 1b signal), ``rel_err`` (||x - Q(x)|| / ||x||) and ``scale_spread``
(log2 of the max over the min group scale).

Inside a data-parallel token split (``core.quantize.TokenSplit``) an
operand with a token axis (``x``, the cotangent ``g``) is a rank's share
of the global batch's.  The reference's stats there are of the global
operand, so each tap computes its share's sums (counts, squared sums,
the extreme scales) from the global groups (a token-spanning group's
amax shared, the subsampled rows the global operand's) and reduces them
over the data group before it finalizes them: every rank then holds one
process's stats (counts exactly, squared sums to rounding).  Under a
tensor-parallel model split (``core.quantize.ModelSplit``) an operand
split over the model group (a column-parallel weight's N block, a
row-parallel one's K block, their activations and cotangents) is
treated the same way over the model group: groups meeting the split
share their amax, the subsampled lines are the global operand's, and
the sums are reduced over the model group.  Under expert parallelism a
rank's expert taps see its own E/m experts: the per-expert stats (each
expert's operands whole) are summed over the model group and divided by
E, the reference's mean over every expert, and the cotangent of a rank's
expert outputs is its contiguous block of the rows of the whole
(expert-major) cotangent, split over the model group along them.
"""
from __future__ import annotations

import contextlib
import re
import threading
from typing import Dict, Optional

import torch

from repro_torch.core import formats as F
from repro_torch.core import routing
from repro_torch.core.quantize import (QuantSpec, _blocked_view,
                                       _group_amax, model_span,
                                       model_split, scale_from_amax,
                                       share_amax, share_model_amax,
                                       spans_ranks, split_state, splitting,
                                       token_split)
from repro_torch.distributed import comms
from repro_torch.core.recipe import MatmulRecipe

__all__ = ["TelemetryCollector", "collecting", "active", "suppressed",
           "snapshot", "replaying",
           "module_scope", "layer_frame", "tap_matmul",
           "tap_matmul_batched", "grad_tap",
           "make_probes", "probe_metrics", "grad_norm_metrics",
           "operand_stats", "cell_error_signals", "PROBE_CLASSES",
           "GRAD_STATS", "PROBE_SIZE", "SCOPE_CLASS"]

_TLS = threading.local()

# Cap on sampled scale groups per operand stat (see ``operand_stats``).
_SAMPLE_GROUPS = 128

# Gradient-side stats per probe row; the final slot counts taps.
GRAD_STATS = ("dgrad_g/clip", "dgrad_g/underflow", "dgrad_g/rel_err",
              "wgrad_g/clip", "wgrad_g/underflow", "wgrad_g/rel_err",
              "gnorm_sq")
PROBE_SIZE = len(GRAD_STATS) + 1

PROBE_CLASSES = ("attn", "ffn", "head", "other")
# module scope -> probe / recipe class
SCOPE_CLASS = {"attn": "attn", "cross": "attn",
               "ffn": "ffn", "moe": "ffn", "ssm": "ffn",
               "head": "head"}


# ---------------------------------------------------------------------------
# Collector and scopes
# ---------------------------------------------------------------------------

class _Frame:
    """One collection frame (per layer, or the loss-level root)."""

    def __init__(self) -> None:
        self.stats: Dict[str, torch.Tensor] = {}
        self._mm: Dict[str, int] = {}

    def next_index(self, scope: str) -> int:
        i = self._mm.get(scope, 0)
        self._mm[scope] = i + 1
        return i


class TelemetryCollector:
    """Frame stack, scope stack and probes for one loss evaluation."""

    def __init__(self) -> None:
        self.reset(None)

    def reset(self, probes) -> None:
        self.probes: Optional[Dict[str, torch.Tensor]] = probes
        self._frames = [_Frame()]
        self._scopes: list = []
        self._layers: list = []

    @property
    def frame(self) -> _Frame:
        return self._frames[-1]

    @property
    def layer_index(self) -> Optional[int]:
        """The current layer, or None outside any layer frame."""
        return self._layers[-1] if self._layers else None

    @property
    def scope_path(self) -> str:
        return "/".join(self._scopes) if self._scopes else "top"

    @property
    def scope_root(self) -> str:
        return self._scopes[0] if self._scopes else "top"

    def drain_root(self) -> Dict[str, torch.Tensor]:
        """Loss-level stats (the LM head's linear), 'tel/'-prefixed."""
        root = self._frames[0]
        out = {f"tel/{k}": v for k, v in root.stats.items()}
        root.stats = {}
        return out


def active() -> Optional[TelemetryCollector]:
    if getattr(_TLS, "suppress", 0):
        return None
    return getattr(_TLS, "collector", None)


@contextlib.contextmanager
def collecting(collector: TelemetryCollector, probes):
    """Install ``collector`` for one loss evaluation."""
    collector.reset(probes)
    prev = getattr(_TLS, "collector", None)
    _TLS.collector = collector
    try:
        yield collector
    finally:
        _TLS.collector = prev


@contextlib.contextmanager
def suppressed():
    """Disable the taps inside."""
    _TLS.suppress = getattr(_TLS, "suppress", 0) + 1
    try:
        yield
    finally:
        _TLS.suppress -= 1


def snapshot():
    """The active collector's probes, scopes and layer stack as they are
    now (None with telemetry off), for :func:`replaying`."""
    col = active()
    if col is None:
        return None
    return col.probes, list(col._scopes), list(col._layers)


@contextlib.contextmanager
def replaying(state):
    """Run a rematerialized forward (``torch.utils.checkpoint``'s
    recompute in the backward) under a throwaway collector that holds the
    ``snapshot`` taken in the original forward: the taps compute what they
    computed there, so the recompute saves the same tensors, but their
    stats go nowhere and no frame or probe row is written twice.  With
    ``state`` None the taps are off."""
    prev = (getattr(_TLS, "collector", None), getattr(_TLS, "suppress", 0))
    shadow = None
    if state is not None:
        shadow = TelemetryCollector()
        shadow.reset(state[0])
        shadow._scopes, shadow._layers = list(state[1]), list(state[2])
    _TLS.collector, _TLS.suppress = shadow, int(state is None)
    try:
        yield
    finally:
        _TLS.collector, _TLS.suppress = prev


@contextlib.contextmanager
def module_scope(name: str):
    """Label the taps inside with a module scope ('attn', 'ffn', ...);
    also the plan-class scope of ``core.routing``."""
    with routing.class_scope(name):
        col = active()
        if col is None:
            yield
            return
        col._scopes.append(name)
        try:
            yield
        finally:
            col._scopes.pop()


@contextlib.contextmanager
def layer_frame(index: Optional[int] = None):
    """Open a per-layer collection frame; yields it (None when telemetry
    is off).  ``index`` routes the layer's backward stats into its probe
    row."""
    col = active()
    if col is None:
        yield None
        return
    fr = _Frame()
    col._frames.append(fr)
    col._layers.append(index)
    try:
        yield fr
    finally:
        col._frames.pop()
        col._layers.pop()


# ---------------------------------------------------------------------------
# Operand statistics
# ---------------------------------------------------------------------------

def _statable(spec: QuantSpec) -> bool:
    return not spec.is_passthrough and spec.fmt != "fp16"


def _subsample(a2d: torch.Tensor, axis: int, token_axis, split,
               model_axis=None, msplit=None) -> torch.Tensor:
    """Every ``stride``-th line of ``a2d`` along ``axis``, ``stride`` from
    the global operand's count there; a rank's share of the token axis
    (or of a model-split axis) keeps the lines the global operand's
    subsample keeps."""
    n = a2d.shape[axis]
    if msplit is not None and axis == model_axis:
        split, token_axis = msplit, model_axis
    if split is None or axis != token_axis:
        stride = n // _SAMPLE_GROUPS
        if stride <= 1:
            return a2d
        return a2d[::stride] if axis == 0 else a2d[:, ::stride]
    stride = n * split.size // _SAMPLE_GROUPS
    if stride <= 1:
        return a2d
    first = -split.offset(n) % stride
    return a2d[first::stride] if axis == 0 else a2d[:, first::stride]


def operand_stats(a2d: torch.Tensor, spec: QuantSpec,
                  reduction_axis: int,
                  token_axis: Optional[int] = None,
                  model_axis: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """Quant-health stats of one matmul operand under ``spec`` (f32 0-dim
    tensors), in one blocked pass, as the reference computes them.

    ``reduction_axis`` is relative to the stored layout.  For ``token`` /
    ``block`` granularities the groups lie along the reduction axis, so
    the operand is strided-subsampled along the other axis to at most
    ``_SAMPLE_GROUPS`` groups first: per-group math stays exact and the
    rates become a sample mean.  ``token_axis``: the axis that runs over
    tokens (None: a weight); inside a token split the stats are the
    global operand's, reduced over the data group (module docstring).
    ``model_axis``: the axis split over the model group (None: whole).
    """
    fmt = spec.format
    split = token_split() if token_axis is not None else None
    msplit = model_split() if model_axis is not None else None
    if spec.granularity in ("token", "block"):
        a2d = _subsample(a2d, 1 - reduction_axis, token_axis, split,
                         model_axis, msplit)
    rows, cols = a2d.shape
    af = _blocked_view(a2d, spec.granularity, spec.block,
                       reduction_axis).to(torch.float32)
    mag = af.abs()
    amax = _group_amax(af, spec.granularity, reduction_axis)
    if split is not None and spans_ranks(
            spec.granularity, spec.block, a2d.shape[token_axis],
            token_axis == reduction_axis):
        amax = share_amax(amax, split)
    if msplit is not None:
        m = a2d.shape[model_axis]
        kind = model_span(spec.granularity, spec.block, m,
                          model_axis == reduction_axis, msplit.size)
        if kind is not None:
            amax = share_model_amax(amax, msplit, kind, m, spec.block)
    scale = scale_from_amax(amax, fmt, spec.pow2_scale)
    q = F.round_to_format(af / scale, fmt) * scale
    nonzero = mag > 0
    under, nz = (nonzero & (q == 0)).sum(), nonzero.sum()
    err2, val2 = ((af - q) ** 2).sum(), (af * af).sum()
    clipped = (mag > scale * (fmt.max_value * (1.0 + 1e-6))).sum()
    smax, smin = scale.max(), scale.min()
    n = rows * cols
    for sp in (split, msplit):
        if sp is not None:
            under, nz, clipped, err2, val2, smax, smin, n = _reduce_sums(
                sp, under, nz, clipped, err2, val2, smax, smin, n)
    underflow = under / torch.clamp(nz, min=1)
    rel_err = torch.sqrt(err2 / torch.clamp(val2, min=1e-30))
    clip = clipped / n
    spread = torch.log2(torch.clamp(smax, min=1e-30)
                        / torch.clamp(smin, min=1e-30))
    return {k: v.to(torch.float32) for k, v in (
        ("clip", clip), ("underflow", underflow), ("rel_err", rel_err),
        ("scale_spread", spread))}


def _reduce_sums(split, under, nz, clipped, err2, val2, smax, smin, n):
    """The group's totals of one operand's stat sums (counts exact in
    f64, squared sums in f32 as the taps hold them), its extreme scales
    (one all-reduce of sums, one of maxima: min as the max of -min)."""
    dev = err2.device
    sums = torch.stack([under.double(), nz.double(), clipped.double(),
                        err2.double(), val2.double(),
                        torch.tensor(float(n), dtype=torch.float64,
                                     device=dev)])
    comms.all_reduce(sums, "sum", split.group, tag="telemetry")
    ext = torch.stack([smax, -smin])
    comms.all_reduce(ext, "max", split.group, tag="telemetry")
    counts = sums[[0, 1, 2]].to(torch.int64)
    return (counts[0], counts[1], counts[2], sums[3].float(),
            sums[4].float(), ext[0], -ext[1], int(sums[5].item()))


# slot -> (operand index, spec name, reduction axis in the stored (M, K)
# x / (K, N) w layout); x's axis 0 runs over tokens
_FWD_SLOTS = (
    ("fwd_x", 0, "fwd_x", 1),      # x quantized over K
    ("fwd_w", 1, "fwd_w", 0),      # w quantized over K
    ("wgrad_x", 0, "wgrad_x", 0),  # x^T quantized over M == x over axis 0
    ("dgrad_w", 1, "dgrad_w", 1),  # w^T quantized over N == w over axis 1
)
_TOKEN_AXIS = (0, None)            # of (x, w)
# of (x, w), per tensor-parallel layout: the axis split over the model
# group (a column-parallel w's N, a row-parallel pair's K)
_MODEL_AXIS = {None: (None, None), "col": (None, 1), "row": (1, 0)}


def _expert_mean(per_e, ep: bool) -> Dict[str, torch.Tensor]:
    """The mean over experts of per-expert stat dicts; ``ep``: the
    rank's block of experts spread over the model group (their sums
    all-reduced, tag ``telemetry``, over every rank's count)."""
    stacked = torch.stack([torch.stack([s_[k] for s_ in per_e])
                           for k in per_e[0]])           # (stats, E)
    split = model_split()
    if not ep or split is None:
        vals = stacked.mean(dim=1)
    else:
        vals = comms.all_reduce(stacked.sum(dim=1), "sum", split.group,
                                tag="telemetry") / (len(per_e) * split.size)
    return dict(zip(per_e[0], vals.unbind()))


def tap_matmul(x2d: torch.Tensor, w: torch.Tensor, recipe: MatmulRecipe,
               fused_fwd: Optional[Dict[str, Optional[Dict]]] = None,
               tp: Optional[str] = None, ep: bool = False) -> None:
    """Record the forward-computable operand stats of one quantized matmul
    into the current frame; no-op without a collector.  ``fused_fwd``
    carries the fwd_x / fwd_w stats that the kernels' epilogue already
    produced (full operand, no subsampling); those slots skip the
    re-computation here.  3-D operands, (E, C, K) x (E, K, N), are a
    batched (per-expert) matmul: each slot's stats are computed per
    expert and averaged, as the reference's ``tap_matmul_batched``
    (``ep``: the operands are an expert-parallel rank's block of the
    experts).  ``tp``: the weight's tensor-parallel layout
    (``core.qlinear``; inside every expert for 3-D operands)."""
    col = active()
    if col is None:
        return
    fr = col.frame
    scope = col.scope_path
    j = fr.next_index(scope)
    ops = (x2d.detach(), w.detach())
    for slot, op_i, spec_name, axis in _FWD_SLOTS:
        spec = getattr(recipe, spec_name)
        if not _statable(spec):
            continue
        pre = fused_fwd.get(slot) if fused_fwd else None
        if pre is not None:
            stats = pre
        elif ops[op_i].dim() == 3:
            per_e = [operand_stats(a, spec, axis, _TOKEN_AXIS[op_i],
                                   _MODEL_AXIS[tp][op_i])
                     for a in ops[op_i]]
            stats = _expert_mean(per_e, ep)
        else:
            stats = operand_stats(ops[op_i], spec, axis,
                                  _TOKEN_AXIS[op_i],
                                  _MODEL_AXIS[tp][op_i])
        for stat, v in stats.items():
            fr.stats[f"{scope}/mm{j}/{slot}/{stat}"] = v


tap_matmul_batched = tap_matmul   # the reference's name for 3-D operands


# ---------------------------------------------------------------------------
# Gradient-side taps (probe gradients)
# ---------------------------------------------------------------------------

def make_probes(n_layers: int, device=None) -> Dict[str, torch.Tensor]:
    """Zero ``(n_layers + 1, PROBE_SIZE)`` probe leaves per module class,
    requiring gradients; row ``n_layers`` collects the taps outside the
    stack (the LM head)."""
    return {c: torch.zeros((n_layers + 1, PROBE_SIZE), dtype=torch.float32,
                           device=device, requires_grad=True)
            for c in PROBE_CLASSES}


def _cotangent_stats(g: torch.Tensor, recipe: MatmulRecipe,
                     tp: Optional[str] = None,
                     ep: bool = False) -> torch.Tensor:
    g2 = g.reshape(-1, g.shape[-1])
    vals = []
    # g's columns are a column-parallel weight's N block; an
    # expert-parallel rank's rows its experts' block
    m_axis = 0 if ep else (1 if tp == "col" else None)
    # dgrad: g reduced over N (axis 1); wgrad: g reduced over M (axis 0);
    # g's rows are tokens
    for spec, axis in ((recipe.dgrad_g, 1), (recipe.wgrad_g, 0)):
        if _statable(spec):
            s = operand_stats(g2, spec, axis, 0, m_axis)
            vals += [s["clip"], s["underflow"], s["rel_err"]]
        else:
            vals += [torch.zeros((), device=g.device)] * 3
    gnorm_sq = (g2.to(torch.float32) ** 2).sum()
    split = token_split()
    if split is not None:
        # a rank's loss is the mean over its own rows, so with equal
        # shares of the targets its cotangent is size x the global
        # loss's: the squared sums are scaled back by size^2 (exact)
        gnorm_sq = comms.all_reduce(gnorm_sq.reshape(1), "sum", split.group,
                                    tag="telemetry")[0] / split.size ** 2
    msplit = model_split()
    if m_axis is not None and msplit is not None:
        gnorm_sq = comms.all_reduce(gnorm_sq.reshape(1), "sum",
                                    msplit.group, tag="telemetry")[0]
    vals.append(gnorm_sq)
    vals.append(torch.ones((), device=g.device))   # tap count
    return torch.stack(vals)


class _GradTap(torch.autograd.Function):
    """Identity on ``y``; its backward passes the cotangent on unchanged
    and returns the cotangent's stats as the probe's gradient, in row
    ``row`` (under the forward's token and model splits: autograd may run
    the backward on a thread of its own)."""

    @staticmethod
    def forward(ctx, y, probe, row: int, recipe: MatmulRecipe,
                tp: Optional[str] = None, ep: bool = False):
        ctx.row, ctx.recipe, ctx.shape = row, recipe, probe.shape
        ctx.split, ctx.tp, ctx.ep = split_state(), tp, ep
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        gp = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        with splitting(*ctx.split):
            gp[ctx.row] = _cotangent_stats(g, ctx.recipe, ctx.tp, ctx.ep)
        return g, gp, None, None, None, None


def grad_tap(y: torch.Tensor, recipe: MatmulRecipe,
             tp: Optional[str] = None, ep: bool = False) -> torch.Tensor:
    """Identity whose backward writes the cotangent's quant stats into the
    current layer's row of its module class's probe; the forward value
    and the cotangent passed upstream are untouched.  ``tp`` / ``ep``:
    as ``tap_matmul``'s (``y`` a column-parallel product's N block, or an
    expert-parallel rank's experts' rows)."""
    col = active()
    if col is None or col.probes is None:
        return y
    if not (_statable(recipe.dgrad_g) or _statable(recipe.wgrad_g)):
        return y
    probe = col.probes[SCOPE_CLASS.get(col.scope_root, "other")]
    idx = col.layer_index
    last = probe.shape[0] - 1
    row = last if idx is None else min(idx, last)
    return _GradTap.apply(y, probe, row, recipe, tp, ep)


def _vec_metrics(vec: torch.Tensor, prefix: str,
                 out: Dict[str, torch.Tensor]) -> None:
    cnt = vec[-1]
    denom = torch.clamp(cnt, min=1.0)
    for i, name in enumerate(GRAD_STATS):
        if name == "gnorm_sq":
            out[f"{prefix}/gout_norm"] = torch.sqrt(vec[i] / denom)
        else:
            out[f"{prefix}/{name}"] = vec[i] / denom
    out[f"{prefix}/taps"] = cnt


def probe_metrics(probe_grads: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """Per-class aggregates ``tel/bwd/<cls>/<stat>`` (rows summed) and
    per-layer rows ``tel/bwd/lNN/<cls>/<stat>`` for the in-stack classes;
    the head's row feeds the aggregate only."""
    out: Dict[str, torch.Tensor] = {}
    for cls, arr in probe_grads.items():
        _vec_metrics(arr.sum(dim=0), f"tel/bwd/{cls}", out)
        if cls == "head":
            continue
        for layer in range(arr.shape[0] - 1):
            _vec_metrics(arr[layer], f"tel/bwd/l{layer:02d}/{cls}", out)
    return out


# ---------------------------------------------------------------------------
# Per-cell error signals (pure Python over a history row)
# ---------------------------------------------------------------------------

_FWD_CELL_RE = re.compile(r"^tel/l(\d+)/([^/]+)/mm\d+/[^/]+/rel_err$")
_BWD_CELL_RE = re.compile(
    r"^tel/bwd/l(\d+)/([^/]+)/(?:dgrad_g|wgrad_g)/rel_err$")
_HEAD_FWD_RE = re.compile(r"^tel/head/mm\d+/[^/]+/rel_err$")
_HEAD_BWD_RE = re.compile(r"^tel/bwd/head/(?:dgrad_g|wgrad_g)/rel_err$")


def cell_error_signals(row: Dict) -> Dict[str, float]:
    """Mean quant relative error per plan cell (``"lNN/<cls>"``, or
    ``"head"``) from one history row: the forward taps of every slot and
    call site joined with the backward probe rows (rows with no taps are
    skipped: an untapped row reads 0.0, which is no signal)."""
    acc: Dict[str, list] = {}
    for k, v in row.items():
        if not isinstance(v, (int, float)):
            continue
        m = _FWD_CELL_RE.match(k)
        if m:
            cls = SCOPE_CLASS.get(m.group(2))
            if cls in ("attn", "ffn"):
                acc.setdefault(f"l{int(m.group(1)):02d}/{cls}",
                               []).append(float(v))
            continue
        m = _BWD_CELL_RE.match(k)
        if m:
            layer, cls = int(m.group(1)), m.group(2)
            if cls not in ("attn", "ffn"):
                continue
            if float(row.get(f"tel/bwd/l{layer:02d}/{cls}/taps", 0.0)) <= 0:
                continue
            acc.setdefault(f"l{layer:02d}/{cls}", []).append(float(v))
            continue
        if _HEAD_FWD_RE.match(k):
            acc.setdefault("head", []).append(float(v))
        elif (_HEAD_BWD_RE.match(k)
              and float(row.get("tel/bwd/head/taps", 0.0)) > 0):
            acc.setdefault("head", []).append(float(v))
    return {c: sum(vs) / len(vs) for c, vs in acc.items()}


# ---------------------------------------------------------------------------
# Per-layer gradient norms
# ---------------------------------------------------------------------------

def grad_norm_metrics(grads) -> Dict[str, torch.Tensor]:
    """Per-layer gradient norms ``tel/gnorm/lNN`` from the params-shaped
    gradient tree, in either stack layout."""
    from repro_torch.tree import tree_leaves
    out: Dict[str, torch.Tensor] = {}
    stack = grads.get("stack") if isinstance(grads, dict) else None
    if not isinstance(stack, dict):
        return out
    if "groups" in stack:
        groups = stack["groups"]
        names = sorted(groups)
        period = len(names)
        for i, lname in enumerate(names):
            ss = sum((leaf.to(torch.float32) ** 2).sum(
                dim=tuple(range(1, leaf.dim())))
                for leaf in tree_leaves(groups[lname]))
            for g in range(ss.shape[0]):
                out[f"tel/gnorm/l{g * period + i:02d}"] = torch.sqrt(ss[g])
    elif "layers" in stack:
        for i, sub in enumerate(stack["layers"]):
            ss = sum((leaf.to(torch.float32) ** 2).sum()
                     for leaf in tree_leaves(sub))
            out[f"tel/gnorm/l{i:02d}"] = torch.sqrt(ss)
    return out
