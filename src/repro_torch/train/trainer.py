"""Training loop with the paper's two-stage schedule, on one device
(counterpart of ``repro.train.trainer``).

The trainer resolves ``TrainConfig.recipe`` into the uniform
``PrecisionPlan``, runs it for stage 1 and switches to the target plan
(``TrainConfig.target_recipe``, default bf16) at
``schedule.switch_step`` (§3.3), keeping one step function per plan.
Each step is timed on the host clock up to a device synchronization and
appended to ``history`` as the reference's row (its metrics, ``step``,
``recipe``, ``dt``, ``straggler``).

Features of the reference's trainer that the port does not have yet —
telemetry and its JSONL log, the adaptive controller, fp8 gradient
compression, meshes, checkpoints and resume, cost calibration, the
depth-graded plan presets, the step timer's warm-up setting — raise
``NotImplementedError`` when their ``TrainConfig`` field is set.
``ModelConfig.remat`` and ``scan_layers`` change no numbers: the port
loops over layers and keeps every activation (gpt2-125m at batch
8 x 1024 fits the card many times over).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.core.recipe import RECIPES, PrecisionPlan
from repro_torch.core.schedule import TargetPrecisionSchedule
from repro_torch.models.model import Model
from repro_torch.train.train_step import (make_eval_step, make_optimizer,
                                          make_train_step)
from repro_torch.tree import tree_map

__all__ = ["Trainer", "TrainState", "StepTimeMonitor"]

_DEFAULTS = TrainConfig()
# field -> the reference feature it turns on, for the fields the port
# refuses when they differ from their default
_UNPORTED = {
    "telemetry": "quantization telemetry",
    "telemetry_jsonl": "the telemetry JSONL log",
    "controller": "the adaptive precision controller",
    "grad_compression": "fp8 gradient compression",
    "mesh_shape": "mesh-native training",
    "checkpoint_every": "checkpointing",
    "cost_calibration": "measured cost calibration",
    "plan_preset": "depth-graded plan presets",
    "profiler_warmup": "the step timer",
}


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: int


class StepTimeMonitor:
    """EMA-based straggler detector (the reference's, unchanged)."""

    def __init__(self, factor: float = 2.5, warmup: int = 5,
                 action: Optional[Callable[[int, float, float], None]] = None):
        self.factor = factor
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.n = 0
        self.flagged: List[int] = []
        self.action = action

    def record(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.ema is None:
            self.ema = dt
            return False
        is_straggler = self.n > self.warmup and dt > self.factor * self.ema
        if is_straggler:
            self.flagged.append(step)
            if self.action:
                self.action(step, dt, self.ema)
        # EMA updated with clipped dt so one outlier doesn't poison it.
        self.ema = 0.9 * self.ema + 0.1 * min(dt, 3 * self.ema)
        return is_straggler


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    def __init__(self, model: Model, tcfg: TrainConfig, pipeline, *,
                 eval_pipeline=None):
        for name, what in _UNPORTED.items():
            if getattr(tcfg, name) != getattr(_DEFAULTS, name):
                raise NotImplementedError(
                    f"TrainConfig.{name}={getattr(tcfg, name)!r}: {what} "
                    "is not ported")
        self.model = model
        self.tcfg = tcfg
        self.pipeline = pipeline
        self.eval_pipeline = eval_pipeline
        self.recipe = RECIPES[tcfg.recipe]
        n_layers = model.cfg.n_layers
        self.plan = PrecisionPlan.uniform(self.recipe, n_layers)
        self.schedule = TargetPrecisionSchedule(
            self.plan, tcfg.total_steps,
            target=PrecisionPlan.uniform(RECIPES[tcfg.target_recipe],
                                         n_layers))
        self._steps: Dict[PrecisionPlan, Callable] = {}
        self.monitor = StepTimeMonitor()
        self.history: List[Dict[str, Any]] = []

    def init_state(self, seed: Optional[int] = None,
                   params=None) -> TrainState:
        """Fresh state: ``params`` (f32 masters, e.g. carried across with
        ``convert.params_from_jax``) moved to the model's device, or a
        seeded init; zeroed optimizer state; step 0."""
        if params is None:
            params = self.model.init(
                self.tcfg.seed if seed is None else seed, torch.float32)
        else:
            params = tree_map(
                lambda p: p.detach().to(self.model.device, torch.float32)
                .clone(), params)
        opt = make_optimizer(self.model, self.tcfg)
        return TrainState(params, opt.init(params), 0)

    def _step_fn(self, plan: PrecisionPlan) -> Callable:
        if plan not in self._steps:
            self._steps[plan] = make_train_step(self.model, self.tcfg, plan)
        return self._steps[plan]

    def _batch(self, pipeline, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.model.device)
                for k, v in pipeline.batch(step).items()}

    def train(self, state: Optional[TrainState] = None,
              num_steps: Optional[int] = None,
              log: Optional[Callable[[str], None]] = None) -> TrainState:
        state = state or self.init_state()
        total = self.tcfg.total_steps
        end = min(total, state.step + (num_steps or total))
        log = log or (lambda s: None)
        dev = self.model.device
        while state.step < end:
            step = state.step
            plan = self.schedule.plan_at(step)
            if self.schedule.is_switch_boundary(step):
                log(f"[schedule] step {step}: switching to target precision "
                    f"({self.schedule.target_plan.name})")
            fn = self._step_fn(plan)
            batch = self._batch(self.pipeline, step)
            # the measured step ends in a device sync, so dt is the device
            # step time and not only the host's dispatch
            _sync(dev)
            t0 = time.perf_counter()
            params, opt_state, metrics = fn(state.params, state.opt_state,
                                            batch, step)
            _sync(dev)
            dt = time.perf_counter() - t0
            straggler = self.monitor.record(step, dt)
            state = TrainState(params, opt_state, step + 1)
            row: Dict[str, Any] = {k: float(v) for k, v in metrics.items()}
            row["step"] = step
            row["recipe"] = plan.name
            row["dt"] = dt
            row["straggler"] = straggler
            self.history.append(row)
            if straggler:
                log(f"[straggler] step {step} took {dt:.2f}s "
                    f"(ema {self.monitor.ema:.2f}s)")
            if self.tcfg.log_every and step % self.tcfg.log_every == 0:
                log(f"step {step:5d} loss {row['loss']:.4f} "
                    f"gnorm {row['grad_norm']:.3f} lr {row['lr']:.2e} "
                    f"[{plan.name}] {dt * 1000:.0f}ms")
        return state

    def evaluate(self, state: TrainState, n_batches: int = 8,
                 recipe=None) -> Dict[str, float]:
        """Mean loss over ``n_batches`` held-out batches (steps 10^7 + i
        of the eval pipeline) under ``recipe`` (a recipe or plan; default
        the BF16 baseline)."""
        fn = make_eval_step(self.model, recipe or RECIPES["bf16"])
        pipeline = self.eval_pipeline or self.pipeline
        losses = [float(fn(state.params,
                           self._batch(pipeline, 10_000_000 + i))["loss"])
                  for i in range(n_batches)]
        val_loss = float(np.mean(losses))
        return {"val_loss": val_loss, "val_ppl": float(np.exp(val_loss))}
