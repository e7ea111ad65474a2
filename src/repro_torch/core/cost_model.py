"""The paper's theoretical compute-cost model (App. B / Tables 2-3),
plan-aware (counterpart of ``repro.core.cost_model``).

Counts matmul FLOPs per role (fwd / dgrad / wgrad) and weights them by
the assumed low-precision speedups: FP8 = 2x FP16 throughput, FP4 = 4x.
The "computation cost" of Tables 2/3 is

    cost(plan) / cost(fp16-everything)   (matmul time only).

:class:`BlockDims` is one transformer block's shape; :class:`ModelDims`
holds per-layer flops (one :class:`LayerDims` per layer plus the
lm-head), from a ``ModelConfig`` via :meth:`ModelDims.from_config`.
:func:`plan_cost` prices a whole ``PrecisionPlan`` per (layer, class,
role); a uniform plan over uniform dims runs the same float operations as
the single-block pricing, so ``plan_cost(PrecisionPlan.uniform(r, n),
ModelDims.from_block(d, n)) == theoretical_cost(r, d)``.
:func:`schedule_cost` integrates the §3.3 stage-2 switch over the step
budget; :func:`compute_share` is Fig. 1(a).

Measured calibration: :func:`calibrate` turns a measured speed-factor
table (``chip_smoke.py``'s ``speed_factors`` phase times each operand-spec
pair of the CUDA kernels against ``torch.matmul``) into a
:class:`CostCalibration`, and the pricing entry points take
``calibration=`` to price wall clock instead of the paper's factors.  The
``speed_factors.v1`` JSON is the reference's file format: either package
reads the other's.

Every function runs the reference's float operations in the reference's
order on Python floats, so the port's costs equal the reference's bit for
bit.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Mapping, Optional, Tuple, Union

from repro_torch.core.quantize import QuantSpec
from repro_torch.core.recipe import (RECIPES, LayerRecipe, MatmulRecipe,
                                     PrecisionPlan, PrecisionRecipe,
                                     stage2_plan)

__all__ = ["block_flops", "theoretical_cost", "compute_share",
           "speed_factor", "BlockDims", "LayerDims", "ModelDims",
           "plan_cost", "schedule_cost", "schedule_adjusted_cost",
           "paper_calibrated_cost", "CostCalibration", "calibrate"]

_SPEED = {"fp32": 0.5, "fp16": 1.0, "bf16": 1.0,
          "fp8_e4m3": 2.0, "fp8_e5m2": 2.0,
          "fp6_e2m3": 2.0, "fp6_e3m2": 2.0,
          "fp4_e2m1": 4.0, "fp4_e1m2": 4.0}


def _cal_key(spec: QuantSpec) -> str:
    """Calibration key of one operand spec: ``fmt`` for passthrough,
    ``fmt@granularity`` otherwise — scale/rounding flags and block size do
    not change kernel throughput class, granularity does (token/tensor
    scales amortize differently from block/tile)."""
    return spec.fmt if spec.is_passthrough else \
        f"{spec.fmt}@{spec.granularity}"


@dataclasses.dataclass(frozen=True)
class CostCalibration:
    """A measured speed-factor table: ``(key_a, key_b) -> factor`` where a
    key is :func:`_cal_key` of an operand spec and the factor is measured
    matmul throughput relative to the plain (bf16/fp16) matmul at the same
    shape — the same normalization as the paper's ``_SPEED`` theory, so
    calibrated and paper costs share one unit (fp16-matmul time).

    Lookup order: exact ``(a, b)``, swapped ``(b, a)``, then the
    format-only pair (granularity wildcards), then ``None`` — callers fall
    back to the paper factor, so a partial measurement still prices every
    plan.
    """

    table: Mapping[Tuple[str, str], float]
    source: str = "measured"

    def lookup(self, spec_a: QuantSpec,
               spec_b: QuantSpec) -> Optional[float]:
        a, b = _cal_key(spec_a), _cal_key(spec_b)
        for key in ((a, b), (b, a),
                    (spec_a.fmt, spec_b.fmt), (spec_b.fmt, spec_a.fmt)):
            if key in self.table:
                return float(self.table[key])
        return None

    # -- persistence (chip_smoke's speed_factors phase writes this form) --

    def to_json(self, path: str) -> None:
        payload = {"schema": "speed_factors.v1", "source": self.source,
                   "factors": {f"{a}|{b}": f
                               for (a, b), f in sorted(self.table.items())}}
        with open(path, "w") as f:
            json.dump(payload, f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "CostCalibration":
        with open(path) as f:
            payload = json.load(f)
        return calibrate(payload["factors"],
                         source=payload.get("source", path))


def calibrate(measured: Mapping, source: str = "measured"
              ) -> CostCalibration:
    """Build a :class:`CostCalibration` from a measured table whose keys
    are ``(key_a, key_b)`` tuples or ``"key_a|key_b"`` strings (the JSON
    form)."""
    table: Dict[Tuple[str, str], float] = {}
    for k, v in measured.items():
        if isinstance(k, str):
            a, _, b = k.partition("|")
            k = (a, b)
        table[(str(k[0]), str(k[1]))] = float(v)
    return CostCalibration(table, source=source)


def speed_factor(spec_a: QuantSpec, spec_b: QuantSpec,
                 calibration: Optional[CostCalibration] = None) -> float:
    """Throughput multiplier of a matmul: the measured factor when a
    ``calibration`` covers the pair, else the paper theory — min of the
    operand formats' assumed speedups."""
    if calibration is not None:
        f = calibration.lookup(spec_a, spec_b)
        if f is not None:
            return f
    return min(_SPEED[spec_a.fmt], _SPEED[spec_b.fmt])


@dataclasses.dataclass(frozen=True)
class BlockDims:
    d_model: int
    d_ff: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    seq_len: int
    n_ff_matmuls: int = 2  # 2 for gelu MLP, 3 for swiglu
    moe_top_k: int = 1     # active experts per token (1 for dense)


def block_flops(d: BlockDims) -> Dict[str, float]:
    """Forward matmul FLOPs per token for one transformer block, by component.

    Returns {'attn_linear', 'attn_sdpa', 'ffn'} in FLOPs/token (x2 mults+adds).
    """
    dm, hd = d.d_model, d.head_dim
    q_out = d.n_heads * hd
    kv_out = 2 * d.n_kv_heads * hd
    attn_linear = 2 * dm * (q_out + kv_out) + 2 * q_out * dm  # QKV + O
    # scores QK^T + context AV, causal -> seq/2 effective
    attn_sdpa = 2 * 2 * d.n_heads * hd * (d.seq_len / 2)
    ffn = d.n_ff_matmuls * 2 * dm * d.d_ff
    if d.n_ff_matmuls == 3:  # swiglu: gate+up (dm->dff) and down (dff->dm)
        ffn = 2 * (2 * dm * d.d_ff) + 2 * d.d_ff * dm
    ffn *= d.moe_top_k
    return {"attn_linear": attn_linear, "attn_sdpa": attn_sdpa, "ffn": ffn}


def compute_share(d: BlockDims) -> Dict[str, float]:
    """Fig. 1(a): fractional share of block forward compute per component."""
    f = block_flops(d)
    tot = sum(f.values())
    return {k: v / tot for k, v in f.items()}


# ---------------------------------------------------------------------------
# Layer-resolved dims (plan-aware pricing)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LayerDims:
    """Forward matmul FLOPs/token of one layer, split by plan class.

    ``attn_linear`` prices this layer's attention-class linears, ``ffn``
    its FFN-class ones (dense MLP, MoE experts x top-k, or the mamba
    in/out projections — the same classing ``models`` uses to pick plan
    cells), and ``attn_sdpa`` the scores/context matmuls, which always
    run at FP16 speed (FlashAttention, App. B).
    """

    attn_linear: float
    attn_sdpa: float
    ffn: float

    @classmethod
    def from_block(cls, d: BlockDims) -> "LayerDims":
        f = block_flops(d)
        return cls(f["attn_linear"], f["attn_sdpa"], f["ffn"])


@dataclasses.dataclass(frozen=True)
class ModelDims:
    """Per-layer flops of a whole model: one :class:`LayerDims` row per
    layer (aligned with ``PrecisionPlan.layers``) plus the lm-head matmul
    (``head_flops`` = 0 excludes the head — the single-block Tables-2/3
    accounting)."""

    layers: Tuple[LayerDims, ...]
    head_flops: float = 0.0

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    @property
    def total_fwd_flops(self) -> float:
        """Forward matmul flops per token, whole model (linears + SDPA +
        lm-head) — the numerator of tokens/sec-based MFU
        (``telemetry.profiler.train_step_flops``)."""
        return sum(ld.attn_linear + ld.attn_sdpa + ld.ffn
                   for ld in self.layers) + self.head_flops

    @classmethod
    def from_block(cls, d: BlockDims, n_layers: int) -> "ModelDims":
        """Uniform depth from a single block's dims, head excluded (the
        pre-plan pricing semantics)."""
        return cls((LayerDims.from_block(d),) * n_layers)

    @classmethod
    def from_config(cls, cfg, seq_len: Optional[int] = None,
                    include_head: bool = True) -> "ModelDims":
        """Resolve a ``configs.base.ModelConfig`` into per-layer dims:
        each attention layer prices QKV+O and the SDPA matmuls (a cross
        sublayer adds a second set), a mamba mixer its in_z / in_x /
        out_proj projections as FFN-class flops (``SCOPE_CLASS`` maps ssm
        -> ffn), a dense FFN the FFN-class flops, a MoE FFN those flops
        scaled by the router top-k, and the lm-head matmul lands in
        ``head_flops`` (the reference's walk over ``cfg.layer_specs()``)."""
        dm = cfg.d_model
        block = BlockDims(
            d_model=dm, d_ff=cfg.d_ff, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            seq_len=seq_len or cfg.max_seq_len,
            n_ff_matmuls=3 if cfg.activation == "swiglu" else 2)
        f = block_flops(block)
        fm = (block_flops(dataclasses.replace(block,
                                              moe_top_k=cfg.moe.top_k))
              if cfg.moe is not None else None)
        ssm_proj = 0.0
        if cfg.mamba is not None:
            d_inner = cfg.mamba.expand * dm
            # in_z + in_x (dm -> d_inner each) + out_proj (d_inner -> dm)
            ssm_proj = 3 * 2 * dm * d_inner
        rows = []
        for spec in cfg.layer_specs():
            attn = sdpa = ffn = 0.0
            if spec.mixer == "attn":
                attn, sdpa = f["attn_linear"], f["attn_sdpa"]
            else:
                ffn += ssm_proj
            if spec.cross:
                attn += f["attn_linear"]
                sdpa += f["attn_sdpa"]
            if spec.ffn == "dense":
                ffn += f["ffn"]
            elif spec.ffn == "moe":
                ffn += fm["ffn"]
            rows.append(LayerDims(attn, sdpa, ffn))
        head = 2.0 * dm * cfg.vocab_size if include_head else 0.0
        return cls(tuple(rows), head)


# ---------------------------------------------------------------------------
# Pricing
# ---------------------------------------------------------------------------

def _mm_time(flops: float, spec_a: QuantSpec, spec_b: QuantSpec,
             cal: Optional[CostCalibration] = None) -> float:
    return flops / speed_factor(spec_a, spec_b, cal)


def _linear_time(flops_fwd: float, mm: MatmulRecipe,
                 cal: Optional[CostCalibration] = None) -> float:
    """fwd + dgrad + wgrad matmul time for a linear of given forward FLOPs."""
    t = _mm_time(flops_fwd, mm.fwd_x, mm.fwd_w, cal)
    t += _mm_time(flops_fwd, mm.dgrad_g, mm.dgrad_w, cal)
    t += _mm_time(flops_fwd, mm.wgrad_x, mm.wgrad_g, cal)
    return t


def _layer_terms(ld: LayerDims, row: LayerRecipe,
                 cal: Optional[CostCalibration] = None
                 ) -> Tuple[float, float]:
    """(time, fp16-baseline time) of one layer under one plan row."""
    t = _linear_time(ld.attn_linear, row.attn_linear, cal)
    t += _linear_time(ld.ffn, row.ffn_linear, cal)
    t += 3.0 * ld.attn_sdpa  # fwd + bwd at FP16 speed
    baseline = 3.0 * (ld.attn_linear + ld.ffn + ld.attn_sdpa)
    return t, baseline


def _coerce_plan(p: Union[PrecisionPlan, PrecisionRecipe],
                 n_layers: Optional[int] = None) -> PrecisionPlan:
    """Cost entry points accept a plan or a recipe template (uniform plan
    of ``n_layers``, default 1 — the depth cancels for uniform pricing)."""
    if isinstance(p, PrecisionPlan):
        return p
    if isinstance(p, PrecisionRecipe):
        return PrecisionPlan.uniform(p, n_layers or 1)
    raise TypeError(
        f"cost model prices PrecisionPlan / PrecisionRecipe, got "
        f"{type(p).__name__}; the recipe-only entry points are deprecated "
        "— coerce via core.recipe.as_plan")


def plan_cost(plan: Union[PrecisionPlan, PrecisionRecipe],
              dims: ModelDims,
              calibration: Optional[CostCalibration] = None) -> float:
    """Matmul time of a whole plan vs the FP16 baseline (Tables 2/3
    "Computation cost", resolved per (layer, class, role)).

    Layers are grouped by (dims row, plan row) and each unique cell is
    priced once.  Exact-parity guarantee: when everything collapses to a
    single group and the head is excluded, the result is ``t / baseline``
    of that one group — the *identical* float arithmetic as the old
    single-block recipe path, so a uniform plan prices bit-identically to
    ``theoretical_cost`` of its template at any depth.

    ``calibration`` swaps the paper speed factors for a measured table
    (see :func:`calibrate`); ``None`` — the default — keeps the paper
    path, bitwise.
    """
    plan = _coerce_plan(plan, dims.n_layers)
    if plan.n_layers != dims.n_layers:
        raise ValueError(f"plan {plan.name!r} has {plan.n_layers} layers, "
                         f"dims has {dims.n_layers}")
    groups: Dict[Tuple[LayerDims, LayerRecipe], int] = {}
    for ld, row in zip(dims.layers, plan.layers):
        groups[(ld, row)] = groups.get((ld, row), 0) + 1
    terms = [(cnt, *_layer_terms(ld, row, calibration))
             for (ld, row), cnt in groups.items()]
    if dims.head_flops:
        terms.append((1, _linear_time(dims.head_flops, plan.head_linear,
                                      calibration),
                      3.0 * dims.head_flops))
    if len(terms) == 1:  # uniform: depth cancels exactly (parity path)
        _, t, baseline = terms[0]
        return t / baseline
    return (sum(c * t for c, t, _ in terms)
            / sum(c * b for c, _, b in terms))


def theoretical_cost(recipe: Union[PrecisionRecipe, PrecisionPlan],
                     d: BlockDims) -> float:
    """Tables 2/3 "Computation cost": matmul time vs the FP16 baseline for
    one representative block.  Accepts the class-template recipe (the
    historical signature) or a full ``PrecisionPlan`` (priced against
    uniform per-layer dims built from ``d``)."""
    plan = _coerce_plan(recipe)
    return plan_cost(plan, ModelDims.from_block(d, plan.n_layers))


def schedule_cost(plan: Union[PrecisionPlan, PrecisionRecipe],
                  dims: ModelDims, *,
                  target: Optional[PrecisionPlan] = None,
                  total_steps: Optional[int] = None,
                  calibration: Optional[CostCalibration] = None) -> float:
    """Cost with the §3.3 stage-2 switch integrated over the step budget.

    Stage 2 runs ``stage2_plan(plan, target)`` (default: the uniform BF16
    baseline, matching ``TargetPrecisionSchedule``).  With ``total_steps``
    the switch step is quantized exactly as the schedule quantizes it
    (``round(total * (1 - frac))``); without, the continuous fraction is
    used.  ``target_precision_frac <= 0`` disables stage 2."""
    plan = _coerce_plan(plan, dims.n_layers)
    lo = plan_cost(plan, dims, calibration)
    frac = plan.target_precision_frac
    if frac <= 0.0:
        return lo
    tgt = target if target is not None else PrecisionPlan.uniform(
        RECIPES["bf16"], plan.n_layers)
    hi = plan_cost(stage2_plan(plan, tgt), dims, calibration)
    if total_steps:
        switch = int(round(total_steps * (1.0 - frac)))
        return (switch * lo + (total_steps - switch) * hi) / total_steps
    return (1.0 - frac) * lo + frac * hi


def schedule_adjusted_cost(recipe: Union[PrecisionRecipe, PrecisionPlan],
                           d: BlockDims) -> float:
    """Cost including the stage-2 high-precision tail (Table 3 rows).

    Historical single-block form: the stage-2 tail is priced at exactly
    1.0 (the FP16 baseline), as the paper tabulates it."""
    plan = _coerce_plan(recipe)
    frac = plan.target_precision_frac
    lo = theoretical_cost(plan, d)
    return (1.0 - frac) * lo + frac * 1.0


# ---------------------------------------------------------------------------
# Paper-calibrated variant.
#
# The paper's exact accounting is underdetermined (it reports only the final
# percentages).  Fitting shares (attn-linear a, FFN f, FP16-fixed s) and a
# bwd:fwd weight w to the four low-precision Table-2 rows gives
#     a = 0.14, f = 0.43, s = 0.43, w = 1.0      (rmse 0.001)
# — i.e. they hold ~43% of block-adjacent compute at FP16 (SDPA + LM head +
# other non-quantized matmuls for a 125M model) and weight backward equal to
# forward.  ``paper_calibrated_cost`` reproduces Table 2 to 3 decimal places;
# ``theoretical_cost`` above is our from-first-principles version (identical
# ordering, more aggressive savings because it counts dgrad+wgrad = 2x fwd
# and only SDPA as fixed).
# ---------------------------------------------------------------------------

_CAL = {"a": 0.14, "f": 0.43, "w": 1.0}


def paper_calibrated_cost(
        recipe: Union[PrecisionRecipe, PrecisionPlan]) -> float:
    plan = _coerce_plan(recipe)
    a, f, w = _CAL["a"], _CAL["f"], _CAL["w"]
    s = 1.0 - a - f
    fwd, bwd = 1.0 / (1.0 + w), w / (1.0 + w)

    def lin(mm: MatmulRecipe) -> float:
        sf = speed_factor(mm.fwd_x, mm.fwd_w)
        # backward speed: slowest of the two backward matmuls
        sb = min(speed_factor(mm.dgrad_g, mm.dgrad_w),
                 speed_factor(mm.wgrad_x, mm.wgrad_g))
        return fwd / sf + bwd / sb

    def class_mean(field: str) -> float:
        """Depth-mean of lin() over the plan's rows; a single unique row
        returns its value directly (recipe-path parity)."""
        groups: Dict[MatmulRecipe, int] = {}
        for row in plan.layers:
            mm = getattr(row, field)
            groups[mm] = groups.get(mm, 0) + 1
        if len(groups) == 1:
            return lin(next(iter(groups)))
        return (sum(cnt * lin(mm) for mm, cnt in groups.items())
                / plan.n_layers)

    return a * class_mean("attn_linear") + f * class_mean("ffn_linear") + s
