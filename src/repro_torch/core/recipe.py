"""Precision recipes and layer-resolved plans (counterpart of
``repro.core.recipe``: the same dataclasses, presets, transforms and spec
strings, so a plan's ``to_dict`` is equal on both sides).

A linear ``y = x @ w`` has three matmuls (fwd, dgrad, wgrad), each with
two quantized operands; ``MatmulRecipe`` holds the six ``QuantSpec``s.
``PrecisionRecipe`` maps module classes (attn / ffn / head) to recipes;
``PrecisionPlan`` resolves that template over depth: uniformly, or
depth-graded (``first_last_k``: the first and last k layers on the
protected FP8 row; ``ramp``: FP8 -> hybrid -> the recipe over the first
``frac`` of the depth); ``promote`` / ``demote`` edit one (layer, class)
cell, a class or the head; ``stage2_plan`` is the §3.3 switch as a plan
transform.  ``RECIPES`` / ``named_recipe`` hold every recipe of the
reference (the Table-2 ablation grid included) with the same spec
strings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core import formats as F
from repro_torch.core.quantize import QuantSpec

__all__ = ["MatmulRecipe", "PrecisionRecipe", "LayerRecipe",
           "PrecisionPlan", "RECIPES", "named_recipe", "as_plan",
           "stage2_plan", "ROLE_SUBSETS",
           "MM_BF16", "MM_FP8", "MM_FP4_ALL", "MM_FFN_PAPER"]

_ROLES = ("fwd_x", "fwd_w", "dgrad_g", "dgrad_w", "wgrad_x", "wgrad_g")


@dataclasses.dataclass(frozen=True)
class MatmulRecipe:
    """Per-role quantization of one linear layer (six operand slots)."""

    fwd_x: QuantSpec = QuantSpec()
    fwd_w: QuantSpec = QuantSpec()
    dgrad_g: QuantSpec = QuantSpec()
    dgrad_w: QuantSpec = QuantSpec()
    wgrad_x: QuantSpec = QuantSpec()
    wgrad_g: QuantSpec = QuantSpec()

    def short(self) -> str:
        return (f"fwd[{self.fwd_x.short()}x{self.fwd_w.short()}] "
                f"dgrad[{self.dgrad_g.short()}x{self.dgrad_w.short()}] "
                f"wgrad[{self.wgrad_x.short()}x{self.wgrad_g.short()}]")

    @property
    def is_passthrough(self) -> bool:
        return all(getattr(self, r).is_passthrough for r in _ROLES)

    def to_dict(self) -> Dict[str, str]:
        return {r: getattr(self, r).to_str() for r in _ROLES}

    @classmethod
    def from_dict(cls, d: Dict[str, str]) -> "MatmulRecipe":
        return cls(**{r: QuantSpec.from_str(d[r]) for r in _ROLES})


def _mm(fwd: str, bwd_w: str, bwd_d: Optional[str], *,
        fwd_gran: str = "token", wgrad_gran: str = "token",
        block: int = 128) -> MatmulRecipe:
    """A MatmulRecipe from format names ('fp4' | 'fp8' | 'bf16'):
    gradients in E5M2, weights/activations in E4M3, weights 'tile' where
    activations are 'block' and 'token' otherwise."""
    act_fmt = {"fp8": "fp8_e4m3", "fp4": "fp4_e2m1"}
    grad_fmt = {"fp8": "fp8_e5m2", "fp4": "fp4_e2m1"}

    def spec(table, name, gran):
        if name == "bf16":
            return QuantSpec("bf16")
        return QuantSpec(table[name], gran, block)

    wgran = "tile" if fwd_gran == "block" else "token"
    bwd_d = bwd_d or "bf16"
    return MatmulRecipe(
        fwd_x=spec(act_fmt, fwd, fwd_gran),
        fwd_w=spec(act_fmt, fwd, wgran),
        dgrad_g=spec(grad_fmt, bwd_d, "token"),
        dgrad_w=spec(act_fmt, bwd_d, "token"),
        wgrad_x=spec(act_fmt, bwd_w, wgrad_gran),
        wgrad_g=spec(grad_fmt, bwd_w, wgrad_gran),
    )


MM_BF16 = MatmulRecipe()
MM_FP8 = _mm("fp8", "fp8", "fp8")
MM_FP4_ALL = _mm("fp4", "fp4", "fp4", fwd_gran="block", wgrad_gran="block")
MM_FFN_PAPER = _mm("fp4", "fp8", None, fwd_gran="block", wgrad_gran="block")


@dataclasses.dataclass(frozen=True)
class PrecisionRecipe:
    """Module-class -> MatmulRecipe mapping for a whole model."""

    name: str
    attn_linear: MatmulRecipe = MM_BF16
    ffn_linear: MatmulRecipe = MM_BF16
    head_linear: MatmulRecipe = MM_BF16
    target_precision_frac: float = 0.0

    def for_class(self, cls: str) -> MatmulRecipe:
        return {"attn": self.attn_linear, "ffn": self.ffn_linear,
                "head": self.head_linear}[cls]

    @property
    def is_passthrough(self) -> bool:
        return (self.attn_linear.is_passthrough
                and self.ffn_linear.is_passthrough
                and self.head_linear.is_passthrough)


_CLASS_FIELD = {"attn": "attn_linear", "ffn": "ffn_linear",
                "head": "head_linear"}

# Role subsets addressable by the plan transforms: each of the three
# matmuls of a linear owns two operand slots.
ROLE_SUBSETS = {"fwd": ("fwd_x", "fwd_w"),
                "dgrad": ("dgrad_g", "dgrad_w"),
                "wgrad": ("wgrad_x", "wgrad_g")}


def _protect(mm: MatmulRecipe) -> MatmulRecipe:
    """Higher-precision stand-in for a class recipe, role-wise: every
    *quantized* role is raised to its FP8 counterpart; passthrough roles
    are untouched.  Per-role matters: MM_FFN_PAPER keeps dgrad in BF16
    (§3.2 — quantizing the activation-gradient path breaks convergence),
    and a protection preset or demotion must never turn that unquantized
    path INTO a quantized FP8 one."""
    repl = {r: getattr(MM_FP8, r) for r in _ROLES
            if not getattr(mm, r).is_passthrough}
    return dataclasses.replace(mm, **repl) if repl else mm


def _demote_mm(mm: MatmulRecipe, roles: Tuple[str, ...],
               fmt: str = "fp4_e2m1") -> MatmulRecipe:
    """Lower the given role subsets of a cell recipe to their low-precision
    (default FP4) counterparts, keeping each operand's scaling spec
    (granularity/block/pow2) intact.  Asymmetric by design: passthrough
    roles are never quantized (the §3.2 BF16 dgrad path stays BF16 —
    demotion only pushes *already-quantized* operands further down), and
    gradient operands (``*_g``) pick up stochastic rounding at FP4 (the
    unbiased-gradient requirement of Quartet / "Optimizing LLM Training
    Using FP4 Quantization")."""
    repl = {}
    for subset in roles:
        for r in ROLE_SUBSETS[subset]:
            spec = getattr(mm, r)
            if spec.is_passthrough:
                continue
            if F.FORMATS[fmt].bits >= spec.format.bits:
                continue  # demotion strictly lowers; fp4 stays fp4
            sr = True if (r.endswith("_g") and fmt.startswith("fp4")) \
                else None
            tgt = spec.with_fmt(fmt, stochastic=sr)
            if tgt != spec:
                repl[r] = tgt
    return dataclasses.replace(mm, **repl) if repl else mm


def _hybrid(mm: MatmulRecipe) -> MatmulRecipe:
    """Middle rung of the FP8->FP4 depth ramp: the forward runs the target
    (low-precision) specs, both backward matmuls stay at the protected
    (FP8) specs — the §3.2 observation that the gradient path is the
    sensitive one, applied per depth rung."""
    if mm.is_passthrough:
        return mm
    hi = _protect(mm)
    return dataclasses.replace(hi, fwd_x=mm.fwd_x, fwd_w=mm.fwd_w)


@dataclasses.dataclass(frozen=True)
class LayerRecipe:
    """One plan row: the class -> MatmulRecipe table of a single layer."""

    attn_linear: MatmulRecipe = MM_BF16
    ffn_linear: MatmulRecipe = MM_BF16

    def for_class(self, cls: str) -> MatmulRecipe:
        return {"attn": self.attn_linear, "ffn": self.ffn_linear}[cls]

    @property
    def is_passthrough(self) -> bool:
        return (self.attn_linear.is_passthrough
                and self.ffn_linear.is_passthrough)

    def to_dict(self) -> Dict[str, Dict[str, str]]:
        return {"attn": self.attn_linear.to_dict(),
                "ffn": self.ffn_linear.to_dict()}

    @classmethod
    def from_dict(cls, d) -> "LayerRecipe":
        return cls(attn_linear=MatmulRecipe.from_dict(d["attn"]),
                   ffn_linear=MatmulRecipe.from_dict(d["ffn"]))


@dataclasses.dataclass(frozen=True)
class PrecisionPlan:
    """Per-layer x module-class x role precision table."""

    name: str
    layers: Tuple[LayerRecipe, ...]
    head_linear: MatmulRecipe = MM_BF16
    target_precision_frac: float = 0.0

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def layer(self, i: int) -> LayerRecipe:
        return self.layers[i]

    def for_class(self, cls: str, layer: Optional[int] = None
                  ) -> MatmulRecipe:
        if cls == "head":
            return self.head_linear
        if layer is None:
            raise ValueError(f"class {cls!r} is layer-resolved; pass layer=")
        return self.layers[layer].for_class(cls)

    @property
    def is_passthrough(self) -> bool:
        return (self.head_linear.is_passthrough
                and all(r.is_passthrough for r in self.layers))

    @property
    def is_uniform(self) -> bool:
        return all(r == self.layers[0] for r in self.layers)

    def scan_runs(self, period: int) -> List[Tuple[int, int]]:
        """Partition layer groups into maximal contiguous runs whose layers
        share a plan signature: ``[(g0, g1), ...)`` group ranges.  Group g
        covers layers ``[g*period, (g+1)*period)``; a uniform plan yields
        the single run ``[(0, n_groups)]`` (the reference runs one
        ``lax.scan`` per run; the port loops over layers either way)."""
        if len(self.layers) % period:
            raise ValueError(f"{len(self.layers)} layers do not split into "
                             f"groups of {period}")
        n_groups = len(self.layers) // period
        runs: List[Tuple[int, int]] = []
        prev_sig = None
        for g in range(n_groups):
            sig = self.layers[g * period:(g + 1) * period]
            if runs and sig == prev_sig:
                runs[-1] = (runs[-1][0], g + 1)
            else:
                runs.append((g, g + 1))
            prev_sig = sig
        return runs

    @classmethod
    def uniform(cls, recipe: PrecisionRecipe, n_layers: int
                ) -> "PrecisionPlan":
        row = LayerRecipe(recipe.attn_linear, recipe.ffn_linear)
        return cls(recipe.name, (row,) * n_layers, recipe.head_linear,
                   recipe.target_precision_frac)

    @classmethod
    def first_last_k(cls, recipe: PrecisionRecipe, n_layers: int,
                     k: int = 2, high: Optional[LayerRecipe] = None
                     ) -> "PrecisionPlan":
        """Depth-graded preset: the first and last ``k`` layers run the
        protected (default FP8) row, the middle runs the recipe (cf. "FP4
        All the Way", which keeps first/last blocks in higher precision)."""
        base = cls.uniform(recipe, n_layers)
        hi = high if high is not None else LayerRecipe(
            _protect(recipe.attn_linear), _protect(recipe.ffn_linear))
        rows = tuple(hi if (i < k or i >= n_layers - k) else base.layers[i]
                     for i in range(n_layers))
        return dataclasses.replace(base, name=f"{recipe.name}+fl{k}",
                                   layers=rows)

    @classmethod
    def ramp(cls, recipe: PrecisionRecipe, n_layers: int,
             frac: float = 0.5) -> "PrecisionPlan":
        """Depth-graded preset: linear FP8 -> FP4 ramp over the first
        ``frac`` of the depth.  Three rungs per class — protected (FP8),
        hybrid (FP4 forward / FP8 backward), full recipe — assigned
        linearly over the ramp region; the remaining depth runs the
        recipe unchanged."""
        ramp_n = max(int(round(frac * n_layers)), 0)
        rungs = (
            LayerRecipe(_protect(recipe.attn_linear),
                        _protect(recipe.ffn_linear)),
            LayerRecipe(_hybrid(recipe.attn_linear),
                        _hybrid(recipe.ffn_linear)),
            LayerRecipe(recipe.attn_linear, recipe.ffn_linear),
        )
        rows = []
        for i in range(n_layers):
            if i >= ramp_n:
                rows.append(rungs[-1])
            else:
                rows.append(rungs[min(i * len(rungs) // ramp_n,
                                      len(rungs) - 1)])
        return cls(f"{recipe.name}+ramp{frac:g}", tuple(rows),
                   recipe.head_linear, recipe.target_precision_frac)

    # -- transforms --------------------------------------------------------

    def promote(self, cls: str, layer: Optional[int] = None,
                to: Optional[MatmulRecipe] = None) -> "PrecisionPlan":
        """Plan with one (layer, class) cell — or a whole class when
        ``layer`` is None, or the head — promoted to higher precision.
        The default target is the role-wise FP8 protection of the cell's
        current recipe (quantized roles -> FP8, passthrough roles — e.g.
        the paper's BF16 FFN dgrad — stay unquantized); pass ``to`` for an
        explicit replacement.  The adaptive controller's per-layer
        demotion rule; no-op (same object) if nothing changes."""
        if cls == "head":
            tgt = to if to is not None else _protect(self.head_linear)
            if self.head_linear == tgt:
                return self
            return dataclasses.replace(
                self, name=f"{self.name}+head=fp8", head_linear=tgt)
        field = _CLASS_FIELD[cls]
        idxs = range(self.n_layers) if layer is None else (layer,)
        rows = list(self.layers)
        changed = False
        for i in idxs:
            cur = getattr(rows[i], field)
            tgt = to if to is not None else _protect(cur)
            if cur != tgt:
                rows[i] = dataclasses.replace(rows[i], **{field: tgt})
                changed = True
        if not changed:
            return self
        where = f"l{layer:02d}." if layer is not None else ""
        return dataclasses.replace(
            self, name=f"{self.name}+{where}{cls}=fp8", layers=tuple(rows))

    def demote(self, cls: str, layer: Optional[int] = None,
               roles: Tuple[str, ...] = ("wgrad",),
               fmt: str = "fp4_e2m1") -> "PrecisionPlan":
        """Plan with a role *subset* of one (layer, class) cell — or a
        whole class when ``layer`` is None, or the head — lowered to its
        ``fmt`` (default FP4) counterpart.  The asymmetric counterpart of
        :meth:`promote`: only the named role subsets move (default
        ``("wgrad",)`` — the §3.2 observation that the wgrad path
        tolerates FP4 long before dgrad does), only already-quantized
        operands are lowered (a BF16 dgrad never becomes quantized), each
        operand keeps its scaling spec, and FP4 gradient operands gain
        stochastic rounding.  The plan searcher's cost-freeing move;
        no-op (same object) if nothing changes."""
        bad = set(roles) - set(ROLE_SUBSETS)
        if bad:
            raise ValueError(f"unknown role subsets {sorted(bad)}; "
                             f"have {sorted(ROLE_SUBSETS)}")
        tag = f"{'+'.join(roles)}={fmt.split('_')[0]}"
        if cls == "head":
            tgt = _demote_mm(self.head_linear, roles, fmt)
            if self.head_linear == tgt:
                return self
            return dataclasses.replace(
                self, name=f"{self.name}+head.{tag}", head_linear=tgt)
        field = _CLASS_FIELD[cls]
        idxs = range(self.n_layers) if layer is None else (layer,)
        rows = list(self.layers)
        changed = False
        for i in idxs:
            cur = getattr(rows[i], field)
            tgt = _demote_mm(cur, roles, fmt)
            if cur != tgt:
                rows[i] = dataclasses.replace(rows[i], **{field: tgt})
                changed = True
        if not changed:
            return self
        where = f"l{layer:02d}." if layer is not None else ""
        return dataclasses.replace(
            self, name=f"{self.name}+{where}{cls}.{tag}",
            layers=tuple(rows))

    def resize(self, n_layers: int) -> "PrecisionPlan":
        """Plan for a different depth by proportional row mapping (exact
        for uniform plans; used for the audio encoder stack, whose depth
        differs from the decoder the plan was built for)."""
        if n_layers == self.n_layers:
            return self
        if self.n_layers == 1 or n_layers == 1:
            rows = (self.layers[0],) * n_layers
        else:
            rows = tuple(
                self.layers[round(i * (self.n_layers - 1)
                                  / (n_layers - 1))]
                for i in range(n_layers))
        return dataclasses.replace(self, layers=rows)

    def to_dict(self) -> Dict:
        """Same dict form as the reference's ``PrecisionPlan.to_dict``."""
        table, index, idxs = [], {}, []
        for row in self.layers:
            if row not in index:
                index[row] = len(table)
                table.append(row.to_dict())
            idxs.append(index[row])
        return {"name": self.name, "head": self.head_linear.to_dict(),
                "target_precision_frac": self.target_precision_frac,
                "rows": table, "layers": idxs}

    @classmethod
    def from_dict(cls, d: Dict) -> "PrecisionPlan":
        table = [LayerRecipe.from_dict(r) for r in d["rows"]]
        return cls(d["name"], tuple(table[i] for i in d["layers"]),
                   MatmulRecipe.from_dict(d["head"]),
                   float(d.get("target_precision_frac", 0.0)))


def as_plan(p: Union[PrecisionPlan, PrecisionRecipe], n_layers: int
            ) -> PrecisionPlan:
    """Coerce a recipe (class template) or plan to a plan of ``n_layers``;
    a plan of the wrong depth is an error."""
    if isinstance(p, PrecisionPlan):
        if p.n_layers != n_layers:
            raise ValueError(f"plan {p.name!r} has {p.n_layers} layers, "
                             f"model has {n_layers}")
        return p
    return PrecisionPlan.uniform(p, n_layers)


def stage2_plan(plan: PrecisionPlan, target: PrecisionPlan
                ) -> PrecisionPlan:
    """The §3.3 stage-2 switch: every row and the head take the target
    plan's cells (identity if already equal)."""
    if (plan.layers == target.layers
            and plan.head_linear == target.head_linear):
        return plan
    return dataclasses.replace(plan, name=target.name, layers=target.layers,
                               head_linear=target.head_linear)


def named_recipe(name: str) -> PrecisionRecipe:
    """A recipe of ``RECIPES`` by name: the paper's (``paper_fp4``,
    ``bf16``, ``fp8``), the Table-2 ablation grid (``all_fp4``,
    ``t2_*``), App. B's size variants and ``fine_grained_fp4``."""
    if name in RECIPES:
        return RECIPES[name]
    raise KeyError(f"unknown recipe {name!r}; have {sorted(RECIPES)}")


RECIPES = {
    "bf16": PrecisionRecipe("bf16"),
    "fp8": PrecisionRecipe("fp8", attn_linear=MM_FP8, ffn_linear=MM_FP8),
    "paper_fp4": PrecisionRecipe(
        "paper_fp4", attn_linear=MM_FP8, ffn_linear=MM_FFN_PAPER,
        target_precision_frac=0.075),
    "paper_fp4_nosched": PrecisionRecipe(
        "paper_fp4_nosched", attn_linear=MM_FP8, ffn_linear=MM_FFN_PAPER),
    # Table 2 ablation grid (attn / ffn / fp4-linear-backward)
    "all_fp4": PrecisionRecipe(
        "all_fp4", attn_linear=MM_FP4_ALL, ffn_linear=MM_FP4_ALL),
    "t2_fp4_fp8_fp8": PrecisionRecipe(
        "t2_fp4_fp8_fp8",
        attn_linear=_mm("fp4", "fp8", "fp8", fwd_gran="block"),
        ffn_linear=MM_FP8),
    "t2_fp8_fp4_fp4": PrecisionRecipe(
        "t2_fp8_fp4_fp4", attn_linear=MM_FP8, ffn_linear=MM_FP4_ALL),
    "t2_fp8_fp4_fp8": PrecisionRecipe(
        "t2_fp8_fp4_fp8", attn_linear=MM_FP8,
        ffn_linear=_mm("fp4", "fp8", "fp8", fwd_gran="block")),
    # App. B model-size-dependent variants
    "gpt125m_fp4": PrecisionRecipe(
        "gpt125m_fp4", attn_linear=MM_FP8,
        ffn_linear=_mm("fp4", "fp4", None, fwd_gran="token",
                       wgrad_gran="token"),
        target_precision_frac=0.075),
    "gpt335m_fp4": PrecisionRecipe(
        "gpt335m_fp4", attn_linear=MM_FP8,
        ffn_linear=_mm("fp4", "fp4", None, fwd_gran="token",
                       wgrad_gran="block"),
        target_precision_frac=0.075),
    "all_fp4_sched": PrecisionRecipe(
        "all_fp4_sched", attn_linear=MM_FP4_ALL, ffn_linear=MM_FP4_ALL,
        target_precision_frac=0.1),
    # beyond the paper: per-block FP4 with stochastic rounding on the
    # FP4 weight gradients (SR is not ported: running it raises)
    "fine_grained_fp4": PrecisionRecipe(
        "fine_grained_fp4", attn_linear=MM_FP8,
        ffn_linear=dataclasses.replace(
            MM_FP4_ALL,
            wgrad_g=QuantSpec("fp4_e2m1", "block", stochastic=True),
            dgrad_g=QuantSpec("fp8_e5m2", "token")),
        target_precision_frac=0.075),
}

