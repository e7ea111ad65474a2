"""Training loop with the paper's two-stage schedule, on one device
(counterpart of ``repro.train.trainer``).

The trainer resolves ``TrainConfig.recipe`` into a ``PrecisionPlan``
(``TrainConfig.plan_preset``: ``uniform``, ``first_last_k`` with
``plan_k``, or ``ramp`` with ``plan_frac``), runs it for stage 1 and
switches to the target plan (``TrainConfig.target_recipe``, default
bf16) at ``schedule.switch_step`` (§3.3), keeping one step function per
plan.
Each step is timed on the host clock up to a device synchronization, fed
to a ``StepTimer`` (``step_time_summary()``) and appended to ``history``
as the reference's row (its metrics, ``step``, ``recipe``, ``dt``,
``straggler``).  With ``TrainConfig.telemetry`` every
``telemetry_every``-th step runs the instrumented step (quant stats in
the row), the others the plain one; with ``telemetry_jsonl`` every row
and every straggler event goes to a JSONL log through the asynchronous
writer, complete when ``train()`` returns.

Checkpoints (``checkpoint_every`` > 0 with a ``checkpoint_dir``):
params, optimizer state and the reference's ``comp_state`` (the
error-feedback residuals under ``grad_compression="fp8"``, else a zero
scalar) every ``checkpoint_every`` steps, in the reference's file
layout (``checkpoint.CheckpointManager``, newest ``keep_checkpoints``
kept, written in the background under ``async_checkpoint``): full,
unsharded arrays, the residuals with their leading replica axis on a
data axis > 1.  ``train()`` with no state starts from ``resume()``,
which restores the newest complete checkpoint, the port's or the
reference's; the plan is re-derived from the restored step, so a run
resumed across the §3.3 switch continues on the right plan and, the
batches being a function of the step, bit for bit.

Adaptive precision (``TrainConfig.controller``, a ``ControllerSettings``):
the telemetry-driven ``PrecisionController`` picks each step's plan
(``_active_plan``: dynamic early switch, per-(layer, class) demotion and,
with ``plan_search``, the greedy cost-vs-quant-error searcher priced on
the model's ``ModelDims``, by the measured speed factors of
``TrainConfig.cost_calibration`` when set), scales the step's LR
(``lr_scale``, backed off on a rollback) and can ask for a loss-spike
rollback: restore the newest checkpoint and replay at the target
precision (``_apply_controller_events``).  Its state rides in the
checkpoint's ``extra["controller"]``, the reference's keys, so a resume
re-derives the plan across a demotion, a search edit or a replay window
too.

Meshes (``TrainConfig.mesh_shape`` / ``mesh_axes``, or ``rules=``): the
trainer builds a ``DeviceMesh`` over the world and ``default_rules``
(``fsdp`` as the config says), and every step, evaluation and checkpoint
runs data-parallel (``train.train_step``).  ``torch.distributed`` must
be initialised by the caller (``torchrun``, or a spawn with a store)
with a world of ``prod(mesh_shape)`` ranks; every rank builds the same
``Trainer``, draws the same seeded init and takes its block; rank 0
logs and writes checkpoints (the others join their gathers); every
rank reads them.  A ``model`` axis larger than 1 splits a dense
attention stack over the model group (Megatron's column- and
row-parallel linears, ``models.attention`` / ``models.mlp``), each rank
holding its blocks of the heads / kv_heads / mlp / vocab leaves and
checkpoints holding the full arrays; any other axis, or a model other
than a dense stack on the model axis, raises ``NotImplementedError``
(ROADMAP queue A).  Without compression
the data-parallel step is the one-device step of the global batch (quant
groups spanning the batch share one amax across the ranks; telemetry
reduces its stats over them); fsdp runs with AdamW or adafactor, and a
spec may shard over part of the data axes (``rules=``).
``ModelConfig.remat`` is honoured in ``models.stack``; ``scan_layers``
changes no numbers (the port loops over layers either way).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import TrainConfig
from repro_torch.core.cost_model import CostCalibration, ModelDims
from repro_torch.core.recipe import RECIPES, PrecisionPlan
from repro_torch.core.schedule import TargetPrecisionSchedule
from repro_torch.models.model import Model
from repro_torch.telemetry.controller import PrecisionController
from repro_torch.telemetry.profiler import (StepTimer, device_peak_flops,
                                            phase_span, train_step_flops)
from repro_torch.distributed import comms
from repro_torch.distributed.sharding import ShardingRules, default_rules
from repro_torch.optim import init_compression_state
from repro_torch.telemetry.writer import AsyncJsonlWriter
from repro_torch.train.train_step import (DataParallel, make_eval_step,
                                          make_optimizer, make_train_step)
from repro_torch.tree import tree_map

__all__ = ["Trainer", "TrainState", "StepTimeMonitor"]


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    comp_state: Any
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


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class Trainer:
    def __init__(self, model: Model, tcfg: TrainConfig, pipeline, *,
                 eval_pipeline=None, rules: Optional[ShardingRules] = None):
        self.model = model
        self.tcfg = tcfg
        self.pipeline = pipeline
        self.eval_pipeline = eval_pipeline
        self.rules = rules if rules is not None else self._build_rules()
        # None on one device or a data axis of 1; raises for a model axis
        self.dp = DataParallel.of(model, self.rules)
        self.rank = _rank()
        self.recipe = RECIPES[tcfg.recipe]
        n_layers = model.cfg.n_layers
        self.plan = self._build_plan(n_layers)
        self.schedule = TargetPrecisionSchedule(
            self.plan, tcfg.total_steps,
            target=PrecisionPlan.uniform(RECIPES[tcfg.target_recipe],
                                         n_layers))
        self._steps: Dict[tuple, Callable] = {}
        self.monitor = StepTimeMonitor()
        self.history: List[Dict[str, Any]] = []
        self.ckpt: Optional[CheckpointManager] = None
        if tcfg.checkpoint_every and tcfg.checkpoint_dir:
            self.ckpt = CheckpointManager(tcfg.checkpoint_dir,
                                          keep=tcfg.keep_checkpoints,
                                          async_save=tcfg.async_checkpoint)
        # layer-resolved flops: the plan searcher's pricing and the MFU of
        # step_time_summary()
        self.dims = ModelDims.from_config(model.cfg, seq_len=tcfg.seq_len)
        # measured speed factors (a speed_factors.v1 JSON); None keeps the
        # paper's theoretical factors
        self.calibration: Optional[CostCalibration] = (
            CostCalibration.from_json(tcfg.cost_calibration)
            if tcfg.cost_calibration else None)
        self.controller: Optional[PrecisionController] = (
            PrecisionController(self.schedule, tcfg.controller,
                                dims=self.dims, calibration=self.calibration)
            if tcfg.controller is not None else None)
        self.timer = StepTimer(warmup=tcfg.profiler_warmup)
        # rows and events go through a bounded queue to a writer thread,
        # so disk latency never lands in a step
        self.writer: Optional[AsyncJsonlWriter] = (
            AsyncJsonlWriter(tcfg.telemetry_jsonl)
            if tcfg.telemetry_jsonl and self.rank == 0 else None)

    def _build_rules(self) -> Optional[ShardingRules]:
        """A mesh over the world and the default rules from
        ``TrainConfig.mesh_shape`` (None without one), as the
        reference's."""
        shape = self.tcfg.mesh_shape
        if shape is None:
            return None
        from repro_torch.distributed.mesh import make_mesh
        axes = self.tcfg.mesh_axes or ("data", "model")[:len(shape)]
        if len(axes) != len(shape):
            raise ValueError(f"mesh_axes {axes} does not match "
                             f"mesh_shape {shape}")
        mesh = make_mesh(tuple(shape), tuple(axes))
        return default_rules(mesh, self.model.cfg, fsdp=self.tcfg.fsdp)

    @property
    def _spmd(self) -> bool:
        """Compression over a data axis > 1: residuals with a replica
        axis."""
        return self.dp is not None and self.tcfg.grad_compression == "fp8"

    def _build_plan(self, n_layers: int) -> PrecisionPlan:
        """``TrainConfig.recipe`` / ``plan_preset`` as a plan (the
        reference's ``_build_plan``)."""
        preset = self.tcfg.plan_preset
        if preset == "uniform":
            return PrecisionPlan.uniform(self.recipe, n_layers)
        if preset == "first_last_k":
            return PrecisionPlan.first_last_k(self.recipe, n_layers,
                                              k=self.tcfg.plan_k)
        if preset == "ramp":
            return PrecisionPlan.ramp(self.recipe, n_layers,
                                      frac=self.tcfg.plan_frac)
        raise ValueError(f"unknown plan_preset {preset!r}")

    def init_state(self, seed: Optional[int] = None,
                   params=None, on_device: bool = False) -> TrainState:
        """Fresh state: ``params`` (f32 masters, e.g. carried across with
        ``convert.params_from_jax``) moved to the model's device, or a
        seeded init (drawn on the CPU, or with ``on_device`` on the
        model's device); zeroed optimizer state and residuals; step 0.
        On a mesh, this rank's blocks."""
        if params is None:
            params = self.model.init(
                self.tcfg.seed if seed is None else seed, torch.float32,
                on_device=on_device)
        else:
            params = tree_map(
                lambda p: p.detach().to(self.model.device, torch.float32)
                .clone(), params)
        if self.tcfg.grad_compression == "fp8":
            comp = init_compression_state(params)
            if self._spmd:
                comp = tree_map(lambda r: r[None], comp)
        else:
            comp = torch.zeros((), dtype=torch.float32,
                               device=self.model.device)
        if self.dp is not None:
            params = self.dp.local(params)
        opt = make_optimizer(self.model, self.tcfg)
        return TrainState(params, opt.init(params), comp, 0)

    def _full_like(self, device):
        """The checkpoint's tree of full arrays on ``device`` (empty
        tensors: a shape template)."""
        params = tree_map(lambda s: torch.empty(s.shape, device=device),
                          self.model.param_specs())
        if self.tcfg.grad_compression == "fp8":
            lead = (self.dp.size,) if self._spmd else ()
            comp = tree_map(lambda p: torch.empty(lead + tuple(p.shape),
                                                  device=device), params)
        else:
            comp = torch.zeros((), device=device)
        return {"params": params,
                "opt_state": make_optimizer(self.model,
                                            self.tcfg).init(params),
                "comp_state": comp}

    def resume(self) -> Optional[TrainState]:
        """The newest complete checkpoint as a state on the model's device
        (None if there is none), in fresh tensors; its step and the
        controller state it carries (loaded into ``self.controller``) pick
        the plan, as in the reference.  Every rank reads the full arrays
        and keeps its blocks."""
        if self.ckpt is None:
            return None
        if dist.is_initialized() and dist.get_world_size() > 1:
            self.ckpt.wait()        # rank 0's pending write
            dist.barrier()
        if self.ckpt.latest_step() is None:
            return None
        like = self._full_like(torch.device("meta"))
        restored, extra = self.ckpt.restore(like, device=self.model.device)
        if self.controller is not None and "controller" in extra:
            self.controller.load_state(extra["controller"])
        params, opt_state = restored["params"], restored["opt_state"]
        comp = restored["comp_state"]
        if self.dp is not None:
            params = self.dp.local(params)
            opt_state = self.dp.local_opt_state(opt_state)
            if self._spmd:
                i = self.dp.index
                comp = tree_map(lambda r: r[i:i + 1].clone(), comp)
        return TrainState(params, opt_state, comp, int(extra["step"]))

    def _gather_comp(self, comp):
        return tree_map(
            lambda r: comms.all_gather(r, self.dp.group, tag="residual")
            .reshape((self.dp.size,) + tuple(r.shape[1:])), comp)

    def save(self, state: TrainState) -> None:
        """Checkpoint ``state`` (no-op without a checkpoint directory) with
        the controller's state; the active plan's table rides along in the
        manifest, as in the reference, for forensics: ``resume``
        re-derives it from the step and the controller state.  On a mesh
        every rank joins the gathers of its blocks and rank 0 writes."""
        if self.ckpt is None:
            return
        params, opt_state, comp = (state.params, state.opt_state,
                                   state.comp_state)
        if self.dp is not None:
            params = self.dp.full(params)
            opt_state = self.dp.full_opt_state(opt_state)
            if self._spmd:
                comp = self._gather_comp(comp)
        if self.rank != 0:
            return
        tree = {"params": params, "opt_state": opt_state,
                "comp_state": comp}
        extra = {"recipe": self.recipe.name,
                 "plan": self._active_plan(state.step).to_dict()}
        if self.controller is not None:
            extra["controller"] = self.controller.state_dict()
        self.ckpt.save(state.step, tree, extra=extra)

    def _step_fn(self, plan: PrecisionPlan,
                 telemetry: Optional[bool] = None) -> Callable:
        """The step of ``plan``, instrumented or not (default: as the
        config says)."""
        tel = self.tcfg.telemetry if telemetry is None else telemetry
        key = (plan, tel)
        if key not in self._steps:
            tcfg = (self.tcfg if tel == self.tcfg.telemetry
                    else dataclasses.replace(self.tcfg, telemetry=tel))
            self._steps[key] = make_train_step(self.model, tcfg, plan,
                                               rules=self.rules)
        return self._steps[key]

    def qlint_report(self, *, trace: bool = False):
        """Precision-flow audit (``analysis.qlint``) of the active plan's
        step plus a recompile-budget census over every step function
        this trainer has built.  It runs one forward and backward on a
        fresh init (``trace``: under a profiler trace of the card); no
        optimizer step, and no state of a run is touched."""
        from repro_torch.analysis import qlint
        return qlint.audit_trainer(self, trace=trace)

    def _batch(self, pipeline, step: int) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.model.device)
                for k, v in pipeline.batch(step).items()}

    def train(self, state: Optional[TrainState] = None,
              num_steps: Optional[int] = None,
              log: Optional[Callable[[str], None]] = None) -> TrainState:
        state = state or self.resume() or self.init_state()
        total = self.tcfg.total_steps
        end = min(total, state.step + (num_steps or total))
        if log is None or self.rank != 0:
            log = lambda s: None   # noqa: E731 -- rank 0 logs
        dev = self.model.device
        while state.step < end:
            step = state.step
            plan = self._active_plan(step)
            if self.controller is None and self.schedule.is_switch_boundary(
                    step):
                log(f"[schedule] step {step}: switching to target precision "
                    f"({self.schedule.target_plan.name})")
            # telemetry sampling: every N-th step runs the instrumented
            # step, the others the plain one
            tel_on = self.tcfg.telemetry and (
                self.tcfg.telemetry_every <= 1
                or step % self.tcfg.telemetry_every == 0)
            fn = self._step_fn(plan, telemetry=tel_on)
            with phase_span("data"):
                batch = self._batch(self.pipeline, step)
            lr_scale = (self.controller.lr_scale
                        if self.controller is not None else 1.0)
            # the measured step ends in a device sync, so dt is the device
            # step time and not only the host's dispatch
            with phase_span("step"):
                _sync(dev)
                t0 = time.perf_counter()
                params, opt_state, comp_state, metrics = fn(
                    state.params, state.opt_state, state.comp_state, batch,
                    step, lr_scale)
                _sync(dev)
                dt = time.perf_counter() - t0
            self.timer.record(dt)
            straggler = self.monitor.record(step, dt)
            state = TrainState(params, opt_state, comp_state, step + 1)
            with phase_span("host"):
                row = self._record(step, plan, metrics, dt, straggler, log)
                # the controller first: a rollback must restore a checkpoint
                # from before the spiked update, so the boundary save comes
                # after the row was judged (or after the restore, keeping
                # the armed replay window)
                if self.controller is not None:
                    state = self._apply_controller_events(
                        state, self.controller.observe(step, row), log)
                if (self.ckpt is not None and self.tcfg.checkpoint_every
                        and (step + 1) % self.tcfg.checkpoint_every == 0):
                    self.save(state)
        if self.ckpt is not None:
            self.ckpt.wait()
        if self.writer is not None:
            self.writer.flush()   # the log is complete once train() returns
        return state

    def _record(self, step, plan, metrics, dt, straggler,
                log) -> Dict[str, Any]:
        """The step's history row (its metrics read in one device-to-host
        copy; returned), the JSONL rows and the log lines."""
        dev = self.model.device
        tensors = [n for n, v in metrics.items()
                   if isinstance(v, torch.Tensor)]
        vals = dict(zip(tensors, torch.stack(
            [metrics[n].detach().to(dev, torch.float32).reshape(())
             for n in tensors]).tolist())) if tensors else {}
        row: Dict[str, Any] = {n: vals[n] if n in vals else float(v)
                               for n, v in metrics.items()}
        row["step"] = step
        row["recipe"] = plan.name
        row["dt"] = dt
        row["straggler"] = straggler
        self.history.append(row)
        if straggler:
            log(f"[straggler] step {step} took {dt:.2f}s "
                f"(ema {self.monitor.ema:.2f}s)")
            if self.writer is not None:
                self.writer.write({"event": "straggler", "step": step,
                                   "dt": dt, "ema": self.monitor.ema,
                                   "factor": self.monitor.factor})
        if self.writer is not None:
            self.writer.write(row)
        if self.tcfg.log_every and step % self.tcfg.log_every == 0:
            log(f"step {step:5d} loss {row['loss']:.4f} "
                f"gnorm {row['grad_norm']:.3f} lr {row['lr']:.2e} "
                f"[{plan.name}] {dt * 1000:.0f}ms")
        return row

    def _active_plan(self, step: int) -> PrecisionPlan:
        """The plan ``step`` runs: the controller's choice, else the §3.3
        schedule's."""
        if self.controller is not None:
            return self.controller.active_plan(step)
        return self.schedule.plan_at(step)

    def _apply_controller_events(self, state: TrainState, events,
                                 log: Callable[[str], None]) -> TrainState:
        """Act on the controller's events (each also goes to the JSONL
        log).  switch / demote / search edits only change what
        ``_active_plan`` picks next; a rollback restores the newest
        checkpoint and arms the replay window at the target precision,
        keeping the attempt count and the LR backoff the controller has
        just applied across the state ``resume`` reloads."""
        ctrl = self.controller
        for ev in events:
            if self.writer is not None:
                self.writer.write(ev)
            if ev["event"] == "switch":
                log(f"[controller] step {ev['step']}: quant-error EMA "
                    f"{ev['error_ema']:.4f} crossed threshold -> early "
                    f"switch to {ev['to']}")
            elif ev["event"] == "demote":
                log(f"[controller] step {ev['step']}: sustained overflow "
                    f"({ev['overflow']:.4f}) -> demoting "
                    f"{ev['cell']} to FP8")
            elif ev["event"] == "frontier_point":
                log(f"[controller] step {ev['step']}: frontier point "
                    f"cost {ev['cost']:.3f} / quant-err {ev['error']:.4f} "
                    f"({ev['plan']})")
            elif ev["event"] == "plan_search":
                log(f"[controller] step {ev['step']}: plan search "
                    f"{ev['op']} {ev['cell']} -> cost {ev['cost']:.3f}")
            elif ev["event"] == "plan_search_done":
                log(f"[controller] step {ev['step']}: plan search done "
                    f"({ev['edits']} edits, "
                    f"{ev['frontier_size']}-point frontier)")
            elif ev["event"] == "rollback":
                attempts, backed_off = ctrl.rollbacks, ctrl.lr_scale
                restored = self.resume()
                if restored is None:
                    log(f"[controller] step {ev['step']}: loss spike "
                        f"({ev['loss']:.3f} vs ema {ev['loss_ema']:.3f}) "
                        "but no checkpoint to roll back to")
                    continue
                ctrl.rollbacks = max(ctrl.rollbacks, attempts)
                ctrl.lr_scale = min(ctrl.lr_scale, backed_off)
                ctrl.begin_replay(restored.step)
                log(f"[controller] step {ev['step']}: loss spike "
                    f"({ev['loss']:.3f} vs ema {ev['loss_ema']:.3f}) -> "
                    f"rollback to step {restored.step}, replaying "
                    f"{ctrl.cfg.replay_steps} steps at "
                    f"{self.schedule.target_plan.name}"
                    + (f", lr_scale {ctrl.lr_scale:.3f}"
                       if ctrl.cfg.lr_backoff > 0 else ""))
                state = restored
        return state

    def close(self) -> None:
        """Close the JSONL writer (its rows are on disk after ``train``
        returns already)."""
        if self.writer is not None:
            self.writer.close()

    def step_time_summary(self) -> Dict[str, float]:
        """Measured step-time statistics of this trainer's run so far:
        p50/p95/p99/mean (ms), tokens/s at the median step, and MFU from
        the model's ``ModelDims`` flops against the peak of the devices
        that ran the step (each rank of a mesh one)."""
        tokens = self.tcfg.global_batch * self.tcfg.seq_len
        ranks = self.dp.world if self.dp is not None else 1
        return self.timer.summary(
            tokens_per_step=tokens,
            flops_per_step=train_step_flops(self.dims, tokens),
            peak_flops=device_peak_flops(self.model.device) * ranks)

    def evaluate(self, state: TrainState, n_batches: int = 8,
                 recipe=None) -> Dict[str, float]:
        """Mean loss over ``n_batches`` held-out batches (steps 10^7 + i
        of the eval pipeline) under ``recipe`` (a recipe or plan; default
        the BF16 baseline)."""
        fn = make_eval_step(self.model, recipe or RECIPES["bf16"],
                            rules=self.rules)
        pipeline = self.eval_pipeline or self.pipeline
        losses = [float(fn(state.params,
                           self._batch(pipeline, 10_000_000 + i))["loss"])
                  for i in range(n_batches)]
        val_loss = float(np.mean(losses))
        return {"val_loss": val_loss, "val_ppl": float(np.exp(val_loss))}
