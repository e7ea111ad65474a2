"""Target-precision training schedule (§3.3) as a plan transform
(counterpart of ``repro.core.schedule``).

Stage 1 trains the first ``1 - frac`` of the steps under the stage-1
plan; stage 2, the final ``frac`` (paper: 5-10%), under the target plan
(``TrainConfig.target_recipe``, default the BF16 baseline), applied with
``core.recipe.stage2_plan``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import recipe as recipe_lib
from repro_torch.core.recipe import PrecisionPlan

__all__ = ["TargetPrecisionSchedule"]


@dataclasses.dataclass(frozen=True)
class TargetPrecisionSchedule:
    plan: PrecisionPlan
    total_steps: int
    target: Optional[PrecisionPlan] = None

    @property
    def switch_step(self) -> int:
        frac = self.plan.target_precision_frac
        if frac <= 0.0:
            return self.total_steps  # never switch
        return int(round(self.total_steps * (1.0 - frac)))

    def plan_at(self, step: int) -> PrecisionPlan:
        """Active plan for ``step`` (0-indexed)."""
        return self.target_plan if step >= self.switch_step else self.plan

    @property
    def target_plan(self) -> PrecisionPlan:
        tgt = self.target or PrecisionPlan.uniform(
            recipe_lib.RECIPES["bf16"], self.plan.n_layers)
        return recipe_lib.stage2_plan(self.plan, tgt)

    def is_switch_boundary(self, step: int) -> bool:
        return step == self.switch_step
