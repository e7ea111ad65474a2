"""Precision recipes and layer-resolved plans (the serving subset of
``repro.core.recipe``).

A linear ``y = x @ w`` has three matmuls (fwd, dgrad, wgrad), each with
two quantized operands; ``MatmulRecipe`` holds the six ``QuantSpec``s.
``PrecisionRecipe`` maps module classes (attn / ffn / head) to recipes;
``PrecisionPlan`` resolves that template over depth.  The serving path
reads only the forward specs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

from repro_torch.core.quantize import QuantSpec

__all__ = ["MatmulRecipe", "PrecisionRecipe", "LayerRecipe",
           "PrecisionPlan", "RECIPES", "as_plan", "MM_BF16", "MM_FP8",
           "MM_FFN_PAPER"]

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

    @property
    def is_passthrough(self) -> bool:
        return all(getattr(self, r).is_passthrough for r in _ROLES)

    def to_dict(self) -> Dict[str, str]:
        return {r: getattr(self, r).to_str() for r in _ROLES}


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
MM_FFN_PAPER = _mm("fp4", "fp8", None, fwd_gran="block", wgrad_gran="block")


@dataclasses.dataclass(frozen=True)
class PrecisionRecipe:
    """Module-class -> MatmulRecipe mapping for a whole model."""

    name: str
    attn_linear: MatmulRecipe = MM_BF16
    ffn_linear: MatmulRecipe = MM_BF16
    head_linear: MatmulRecipe = MM_BF16
    target_precision_frac: float = 0.0


@dataclasses.dataclass(frozen=True)
class LayerRecipe:
    """One plan row: the class -> MatmulRecipe table of a single layer."""

    attn_linear: MatmulRecipe = MM_BF16
    ffn_linear: MatmulRecipe = MM_BF16

    def to_dict(self) -> Dict[str, Dict[str, str]]:
        return {"attn": self.attn_linear.to_dict(),
                "ffn": self.ffn_linear.to_dict()}


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

    @classmethod
    def uniform(cls, recipe: PrecisionRecipe, n_layers: int
                ) -> "PrecisionPlan":
        row = LayerRecipe(recipe.attn_linear, recipe.ffn_linear)
        return cls(recipe.name, (row,) * n_layers, recipe.head_linear,
                   recipe.target_precision_frac)

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


RECIPES = {
    "bf16": PrecisionRecipe("bf16"),
    "fp8": PrecisionRecipe("fp8", attn_linear=MM_FP8, ffn_linear=MM_FP8),
    "paper_fp4": PrecisionRecipe(
        "paper_fp4", attn_linear=MM_FP8, ffn_linear=MM_FFN_PAPER,
        target_precision_frac=0.075),
}
