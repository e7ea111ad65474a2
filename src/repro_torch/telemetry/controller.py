"""Adaptive precision controller driven by live quantization telemetry
(counterpart of ``repro.telemetry.controller``).

Generalizes the static §3.3 two-stage schedule with decision rules, each
opt-in via ``configs.base.ControllerSettings``:

  * **Dynamic target-precision switch** — switch to the stage-2 (target)
    plan when the EMA of the forward quant relative error crosses a
    threshold, or at the schedule's fixed fraction, whichever comes first.
  * **Per-(layer, class) demotion** — sustained wgrad overflow (clip rate)
    of one layer's module class promotes that single cell FP4 -> FP8 via
    ``PrecisionPlan.promote``; the lm-head demotes as the ``head`` cell.
  * **Loss-spike rollback** — a loss spike against its EMA asks the
    trainer to restore the last checkpoint and replay ``replay_steps``
    steps at the target (high) precision; with ``lr_backoff`` the LR
    scale shrinks on each rollback and recovers geometrically over
    ``lr_recovery_steps`` steps.
  * **Plan search** (``plan_search``) — :class:`PlanSearcher` walks the
    stage-1 plan along the cost-vs-quant-error frontier: every
    ``plan_search_every`` steps it finalizes a measured frontier point
    for the running plan (``core.cost_model.plan_cost`` x the window's
    mean forward quant error) and applies one greedy edit — promote the
    worst-error (layer, class) cell to FP8, or, when the cost budget is
    spent, demote the healthiest cell's wgrad roles to FP4.

The controller is pure Python over the per-step history rows; precision
changes are plan swaps, so the trainer keeps one step function per plan.
Its decision state persists in the checkpoint's ``extra`` with the
reference's keys and JSON types, so either package restores the other's
controller state, and on identical rows both emit identical events and
state, bit for bit (Python floats, the reference's operations in its
order).
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ControllerSettings
from repro_torch.core import recipe as recipe_lib
from repro_torch.core.cost_model import CostCalibration, ModelDims, plan_cost
from repro_torch.core.schedule import TargetPrecisionSchedule
from repro_torch.telemetry.collect import SCOPE_CLASS, cell_error_signals

__all__ = ["PrecisionController", "PlanSearcher"]

_CLASSES = ("attn", "ffn", "head")
_LAYER_SEG = re.compile(r"^l(\d+)$")


def _fwd_error_signal(row: Dict) -> Optional[float]:
    """Mean forward quant relative error across all layers/slots."""
    vals = [v for k, v in row.items()
            if k.startswith("tel/") and "/fwd_" in k
            and k.endswith("/rel_err") and isinstance(v, (int, float))]
    return sum(vals) / len(vals) if vals else None


def _demote_target(key: str) -> Optional[str]:
    """Map a wgrad-clip metric key to its demotion cell.

    Cells are ``"lNN/<cls>"`` for in-stack layers and ``"head"`` for the
    lm-head.  Key shapes:

      tel/lNN/<scope>/mmJ/wgrad_x/clip   fwd-side per-layer tap
      tel/bwd/lNN/<cls>/wgrad_g/clip     indexed backward probe row
      tel/head/mmJ/wgrad_x/clip          root frame (lm-head)
      tel/bwd/head/wgrad_g/clip          head probe aggregate

    Per-class backward aggregates (``tel/bwd/<cls>/...``) are skipped for
    in-stack classes — their layer-resolved rows carry the signal.
    """
    if not (key.startswith("tel/") and "wgrad" in key
            and key.endswith("/clip")):
        return None
    parts = key.split("/")
    if parts[1] == "bwd":
        m = _LAYER_SEG.match(parts[2])
        if m:
            cls = parts[3] if parts[3] in _CLASSES else None
            return f"l{int(m.group(1)):02d}/{cls}" if cls else None
        return "head" if parts[2] == "head" else None
    m = _LAYER_SEG.match(parts[1])
    if m:
        cls = SCOPE_CLASS.get(parts[2], parts[2] if parts[2] in _CLASSES
                              else None)
        return f"l{int(m.group(1)):02d}/{cls}" if cls else None
    scope = parts[1]
    cls = scope if scope in _CLASSES else SCOPE_CLASS.get(scope)
    return "head" if cls == "head" else None


def _wgrad_overflow_by_cell(row: Dict) -> Dict[str, float]:
    """Mean wgrad-operand clip rate per (layer, class) cell."""
    acc: Dict[str, List[float]] = {}
    for k, v in row.items():
        cell = _demote_target(k)
        if cell is not None and isinstance(v, (int, float)):
            acc.setdefault(cell, []).append(float(v))
    return {c: sum(vs) / len(vs) for c, vs in acc.items()}


def _parse_cell(cell: str) -> Tuple[Optional[int], str]:
    """``"l03/ffn"`` -> (3, "ffn");  ``"head"`` -> (None, "head")."""
    if cell == "head":
        return None, "head"
    lseg, cls = cell.split("/")
    return int(lseg[1:]), cls


def _dominates(a: Dict, b: Dict) -> bool:
    """Pareto dominance on (cost, error): a is no worse on both axes and
    strictly better on at least one."""
    return (a["cost"] <= b["cost"] and a["error"] <= b["error"]
            and (a["cost"] < b["cost"] or a["error"] < b["error"]))


class PlanSearcher:
    """Telemetry-driven greedy walk along the cost-vs-quant-error frontier.

    Consumes per-cell quant-error signals (``collect.cell_error_signals``,
    EMA'd), prices candidate plans with ``core.cost_model.plan_cost``, and
    edits the stage-1 plan one cell at a time: promote the worst cell
    (FP4 -> FP8, ``PrecisionPlan.promote``) while the cost budget allows,
    demote the healthiest cell's wgrad roles (FP8 -> FP4,
    ``PrecisionPlan.demote`` — the asymmetric role-subset transform;
    dgrad never moves) to free budget.  Each applied plan runs for a
    measurement window and lands on the frontier with its *measured* mean
    forward quant error, so the frontier is empirical, not modelled.

    All state is JSON-able and float-exact through a json round-trip, so
    checkpoint resume replays the search bit-exactly.

    ``calibration`` (a ``cost_model.CostCalibration``) swaps the paper
    speed factors for measured wall-clock throughput in every
    ``plan_cost`` the search makes — frontier points, budget checks and
    candidate ranking all price the same way, so the frontier is measured
    on BOTH axes.  It is configuration, not search state: it does not
    persist in ``state_dict`` and a resume must be constructed with the
    same table to replay identically.
    """

    def __init__(self, dims: ModelDims, settings: ControllerSettings,
                 calibration: Optional[CostCalibration] = None):
        self.dims = dims
        self.cfg = settings
        self.calibration = calibration
        self.cell_err: Dict[str, float] = {}   # per-cell rel_err EMA
        self.edits: List[List[str]] = []       # applied [op, cell] pairs
        self.frontier: List[Dict] = []         # Pareto-pruned points
        self.done = False
        self._err_sum = 0.0                    # current window accumulator
        self._err_n = 0
        self._window_start: Optional[int] = None
        self._plan_cache: Dict[tuple, recipe_lib.PrecisionPlan] = {}

    # -- plan derivation ---------------------------------------------------

    @staticmethod
    def _apply_edits(base: recipe_lib.PrecisionPlan,
                     edits) -> recipe_lib.PrecisionPlan:
        p = base
        for op, cell in edits:
            layer, cls = _parse_cell(cell)
            p = (p.promote(cls, layer=layer) if op == "promote"
                 else p.demote(cls, layer=layer))
        return p

    def apply(self, base: recipe_lib.PrecisionPlan
              ) -> recipe_lib.PrecisionPlan:
        """Base plan with every applied search edit, cached by
        (base, edits) so repeated lookups return the same plan object
        (the trainer keys its step functions by plan)."""
        if not self.edits:
            return base
        key = (base, tuple(tuple(e) for e in self.edits))
        if key not in self._plan_cache:
            self._plan_cache[key] = self._apply_edits(base, self.edits)
        return self._plan_cache[key]

    # -- observation / search ----------------------------------------------

    def reset_window(self) -> None:
        """Discard the current measurement window.  The controller calls
        this when a safety demotion changes the effective plan mid-window
        — the partial measurement belongs to the pre-demotion plan and
        must not be attributed to the post-demotion one."""
        self._err_sum, self._err_n = 0.0, 0
        self._window_start = None

    def observe(self, step: int, row: Dict) -> None:
        if self.done:
            return
        d = self.cfg.error_ema_decay
        for cell, e in cell_error_signals(row).items():
            prev = self.cell_err.get(cell)
            self.cell_err[cell] = (e if prev is None
                                   else d * prev + (1 - d) * e)
        e = _fwd_error_signal(row)
        if e is not None:
            if self._window_start is None:
                self._window_start = step
            self._err_sum += e
            self._err_n += 1

    def maybe_move(self, step: int, base: recipe_lib.PrecisionPlan,
                   overlay=None) -> List[Dict]:
        """Finalize the current plan's frontier point and apply the next
        greedy edit, once the measurement window is full.  Returns
        controller events (``frontier_point`` / ``plan_search`` /
        ``plan_search_done``).

        ``overlay`` (the controller passes its ``_demoted_plan``) maps a
        searcher-edited plan to the plan the steps *actually ran* —
        search edits compose with safety demotions, and both the frontier
        pricing/labels and the candidate evaluation use the effective
        plan, so a cell the controller already protected is never
        re-proposed and a point's cost always matches its measured error."""
        if self.done or self._window_start is None or self._err_n == 0:
            return []
        if step - self._window_start + 1 < max(self.cfg.plan_search_every,
                                               1):
            return []
        overlay = overlay or (lambda p: p)
        cur = overlay(self.apply(base))
        point = {"event": "frontier_point", "step": step,
                 "cost": plan_cost(cur, self.dims, self.calibration),
                 "error": self._err_sum / self._err_n,
                 "plan": cur.name,
                 "edits": [list(e) for e in self.edits]}
        self._push_frontier(point)
        events = [point]
        move = self._next_edit(base, cur, overlay)
        if move is None:
            self.done = True
            events.append({"event": "plan_search_done", "step": step,
                           "edits": len(self.edits),
                           "frontier_size": len(self.frontier)})
            return events
        self.edits.append(list(move))
        new = overlay(self.apply(base))
        self._err_sum, self._err_n = 0.0, 0   # fresh window for the new plan
        self._window_start = None
        events.append({"event": "plan_search", "step": step,
                       "op": move[0], "cell": move[1],
                       "cell_error": self.cell_err.get(move[1]),
                       "cost": plan_cost(new, self.dims, self.calibration),
                       "plan": new.name})
        return events

    def _push_frontier(self, point: Dict) -> None:
        keep = [p for p in self.frontier if not _dominates(point, p)]
        if not any(_dominates(p, point)
                   or (p["cost"] == point["cost"]
                       and p["error"] == point["error"]) for p in keep):
            keep.append(point)
        self.frontier = sorted(keep,
                               key=lambda p: (p["cost"], p["error"]))

    def _next_edit(self, base: recipe_lib.PrecisionPlan,
                   cur: recipe_lib.PrecisionPlan,
                   overlay) -> Optional[Tuple[str, str]]:
        """Candidates are judged by their *effective* plan — edits plus
        the overlay — so an edit the overlay nullifies (e.g. promoting a
        cell the controller already demoted) is skipped, not wasted."""
        if len(self.edits) >= self.cfg.plan_search_max_edits:
            return None
        budget = self.cfg.plan_search_cost_budget
        touched = {e[1] for e in self.edits}
        # Promote the worst-error cell whose promotion is a real change
        # and fits the cost budget.
        for cell, err in sorted(self.cell_err.items(),
                                key=lambda kv: (-kv[1], kv[0])):
            if cell in touched:
                continue
            cand = overlay(self._apply_edits(
                base, self.edits + [["promote", cell]]))
            if cand == cur:
                continue
            if budget <= 0 or plan_cost(cand, self.dims,
                                        self.calibration) <= budget:
                return ("promote", cell)
            break  # worst cell busts the budget: free cost via demotion
        # Demote the healthiest cell's wgrad roles (never dgrad).
        thr = self.cfg.plan_search_demote_threshold
        if thr > 0:
            for cell, err in sorted(self.cell_err.items(),
                                    key=lambda kv: (kv[1], kv[0])):
                if err > thr:
                    break
                if cell in touched:
                    continue
                cand = overlay(self._apply_edits(
                    base, self.edits + [["demote", cell]]))
                if cand != cur:
                    return ("demote", cell)
        return None

    # -- checkpoint persistence --------------------------------------------

    def state_dict(self) -> Dict:
        return {"cell_err": dict(self.cell_err),
                "edits": [list(e) for e in self.edits],
                "frontier": [dict(p) for p in self.frontier],
                "done": self.done,
                "err_sum": self._err_sum,
                "err_n": self._err_n,
                "window_start": self._window_start}

    def load_state(self, state: Dict) -> None:
        self.cell_err = {str(k): float(v)
                         for k, v in state.get("cell_err", {}).items()}
        self.edits = [list(e) for e in state.get("edits", [])]
        self.frontier = [dict(p) for p in state.get("frontier", [])]
        self.done = bool(state.get("done", False))
        self._err_sum = float(state.get("err_sum", 0.0))
        self._err_n = int(state.get("err_n", 0))
        ws = state.get("window_start")
        self._window_start = None if ws is None else int(ws)
        self._plan_cache = {}


class PrecisionController:
    """Consumes per-step telemetry rows; owns the active-plan decision."""

    def __init__(self, schedule: TargetPrecisionSchedule,
                 settings: Optional[ControllerSettings] = None,
                 dims: Optional[ModelDims] = None,
                 calibration: Optional[CostCalibration] = None):
        self.schedule = schedule
        self.cfg = settings or ControllerSettings()
        self.error_ema: Optional[float] = None
        self.loss_ema: Optional[float] = None
        self._loss_n = 0
        self.switched_at: Optional[int] = None
        self.demoted: List[str] = []          # "lNN/<cls>" | "head" cells
        self._streak: Dict[str, int] = {}
        self.replay_until: int = -1
        self.rollbacks = 0
        self.lr_scale: float = 1.0
        self.events: List[Dict] = []
        self._plan_cache: Dict[tuple, recipe_lib.PrecisionPlan] = {}
        self.searcher: Optional[PlanSearcher] = None
        if self.cfg.plan_search:
            if dims is None:
                raise ValueError(
                    "ControllerSettings.plan_search needs the model's "
                    "ModelDims — pass PrecisionController(..., dims=...) "
                    "(the Trainer derives them from ModelConfig)")
            self.searcher = PlanSearcher(dims, self.cfg,
                                         calibration=calibration)

    # -- plan selection ----------------------------------------------------

    def active_plan(self, step: int) -> recipe_lib.PrecisionPlan:
        if step < self.replay_until:
            # post-rollback replay at the target precision
            return self._demoted_plan(self.schedule.target_plan)
        if self.switched_at is not None and step >= self.switched_at:
            # dynamic early switch
            return self._demoted_plan(self.schedule.target_plan)
        base = self.schedule.plan_at(step)    # fixed-fraction switch
        if base is self.schedule.plan and self.searcher is not None:
            base = self.searcher.apply(base)  # search edits: stage 1 only
        return self._demoted_plan(base)

    def _demoted_plan(self, base: recipe_lib.PrecisionPlan
                      ) -> recipe_lib.PrecisionPlan:
        """Re-apply every latched demotion to whichever base plan is
        active.  Demotions survive the §3.3 switch: ``promote`` is a
        role-wise no-op on cells the stage-2 plan no longer quantizes, so
        a demoted cell stays protected exactly when the target plan would
        still quantize it.  The cache is keyed by (base, cells) — keyed by
        cells alone, a plan derived from one base would be served for
        another once ``plan_at(step)`` varies."""
        if not self.demoted:
            return base
        key = (base, ",".join(sorted(self.demoted)))
        if key not in self._plan_cache:
            p = base
            for cell in sorted(self.demoted):
                layer, cls = _parse_cell(cell)
                p = p.promote(cls, layer=layer)
            self._plan_cache[key] = p
        return self._plan_cache[key]

    # -- observation -------------------------------------------------------

    def observe(self, step: int, row: Dict) -> List[Dict]:
        """Digest one history row; returns controller events (possibly
        including a ``rollback`` request the trainer must act on)."""
        events: List[Dict] = []
        in_replay = step < self.replay_until
        events += self._observe_error(step, row)
        events += self._observe_overflow(step, row)
        if not in_replay:
            events += self._observe_loss(step, row)
        if self.searcher is not None:
            if any(e["event"] == "demote" for e in events):
                # the effective plan just changed under the searcher: the
                # partial window measured the pre-demotion plan.  Checked
                # unconditionally (demotions latch during replay too, when
                # the search itself is gated off).
                self.searcher.reset_window()
            elif (not in_replay and self.switched_at is None
                    and step + 1 < self.schedule.switch_step):
                # search only while stage 1 still has steps to run: an
                # edit at ``step`` first applies at ``step + 1``
                self.searcher.observe(step, row)
                events += self.searcher.maybe_move(
                    step, self.schedule.plan, overlay=self._demoted_plan)
        self._observe_lr(events)
        self.events += events
        return events

    def _observe_error(self, step: int, row: Dict) -> List[Dict]:
        e = _fwd_error_signal(row)
        if e is None:
            return []
        d = self.cfg.error_ema_decay
        self.error_ema = (e if self.error_ema is None
                          else d * self.error_ema + (1 - d) * e)
        thr = self.cfg.switch_error_threshold
        if (thr > 0 and self.error_ema > thr and self.switched_at is None
                and step < self.schedule.switch_step):
            self.switched_at = step + 1
            return [{"event": "switch", "step": step,
                     "error_ema": self.error_ema,
                     "to": self.schedule.target_plan.name}]
        return []

    def _observe_overflow(self, step: int, row: Dict) -> List[Dict]:
        thr = self.cfg.demote_overflow_threshold
        if thr <= 0:
            return []
        events = []
        for cell, rate in _wgrad_overflow_by_cell(row).items():
            if rate > thr:
                self._streak[cell] = self._streak.get(cell, 0) + 1
            else:
                self._streak[cell] = 0
            if (self._streak[cell] >= self.cfg.demote_patience
                    and cell not in self.demoted):
                self.demoted.append(cell)
                layer, cls = _parse_cell(cell)
                events.append({"event": "demote", "step": step,
                               "cell": cell, "layer": layer,
                               "module_class": cls, "overflow": rate})
        return events

    def _observe_loss(self, step: int, row: Dict) -> List[Dict]:
        if self.cfg.spike_factor <= 0 or "loss" not in row:
            return []
        loss = float(row["loss"])
        self._loss_n += 1
        if self.loss_ema is None:
            self.loss_ema = loss
            return []
        is_spike = (self._loss_n > self.cfg.spike_warmup
                    and loss > self.cfg.spike_factor * self.loss_ema)
        if is_spike and self.rollbacks < self.cfg.max_rollbacks:
            self.rollbacks += 1
            return [{"event": "rollback", "step": step, "loss": loss,
                     "loss_ema": self.loss_ema}]
        d = self.cfg.loss_ema_decay
        self.loss_ema = d * self.loss_ema + (1 - d) * loss
        return []

    # -- LR backoff (satellite: controller-driven LR backoff) --------------

    def _observe_lr(self, events: List[Dict]) -> None:
        """Shrink the LR scale on each rollback; otherwise recover it
        geometrically so it reaches 1.0 after ~``lr_recovery_steps`` clean
        steps per backoff applied."""
        if self.cfg.lr_backoff <= 0:
            return
        if any(e["event"] == "rollback" for e in events):
            self.lr_scale *= self.cfg.lr_backoff
            for e in events:
                if e["event"] == "rollback":
                    e["lr_scale"] = self.lr_scale
        elif self.lr_scale < 1.0:
            rate = (1.0 / self.cfg.lr_backoff) ** (
                1.0 / max(self.cfg.lr_recovery_steps, 1))
            self.lr_scale = min(1.0, self.lr_scale * rate)

    # -- rollback handshake (trainer-owned checkpoint restore) -------------

    def begin_replay(self, restored_step: int) -> None:
        """Trainer restored a checkpoint at ``restored_step``; replay the
        next ``replay_steps`` steps at the target precision."""
        self.replay_until = restored_step + self.cfg.replay_steps
        self._loss_n = 0  # re-warm spike detection after the rewind

    # -- checkpoint persistence --------------------------------------------

    def state_dict(self) -> Dict:
        out = {"switched_at": self.switched_at,
               "demoted": list(self.demoted),
               "replay_until": self.replay_until,
               "rollbacks": self.rollbacks,
               "lr_scale": self.lr_scale}
        if self.searcher is not None:
            out["plan_search"] = self.searcher.state_dict()
        return out

    def load_state(self, state: Dict) -> None:
        self.switched_at = state.get("switched_at")
        self.demoted = list(state.get("demoted", []))
        self.replay_until = int(state.get("replay_until", -1))
        self.rollbacks = int(state.get("rollbacks", 0))
        self.lr_scale = float(state.get("lr_scale", 1.0))
        if self.searcher is not None and state.get("plan_search"):
            self.searcher.load_state(state["plan_search"])
