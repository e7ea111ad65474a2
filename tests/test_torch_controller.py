"""The port's adaptive precision controller and plan searcher
(``repro_torch.telemetry.controller``) against the reference's.

Synthetic rows (bar: ``==``).  Both packages' ``PrecisionController`` /
``PlanSearcher`` are fed the same rows in lockstep, with the trainer's
rollback handshake (restore the newest saved state, keep the attempt
count and the backed-off LR scale, ``begin_replay``) played by
``_lockstep``.  At every step the events, ``active_plan`` (as a dict) and
``state_dict()`` must be equal.  The rows are those of the reference's
own controller and searcher tests, and a seeded random stream that
crosses every rule.  Midway, each package's ``state_dict`` (through JSON)
is loaded into a fresh controller of the other package and of its own,
and the three continue in lockstep.

Trainer level, in the port alone: a depth-graded demotion resume on
``tiny`` (f32, ``linear_impl="qdq"``), bit for bit against the
uninterrupted port run.  The trainer-level comparisons with the JAX
``Trainer`` are in ``test_torch_controller_trainer.py``.
"""
import importlib
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.core import cost_model as j_cost  # noqa: E402
from repro.core import recipe as j_recipe  # noqa: E402
from repro.core.schedule import TargetPrecisionSchedule as JSched  # noqa
from repro.telemetry import controller as j_ctrl  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.core import cost_model as t_cost  # noqa: E402
from repro_torch.core import recipe as t_recipe  # noqa: E402
from repro_torch.core.schedule import TargetPrecisionSchedule  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.telemetry import controller as t_ctrl  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

PKGS = {"j": (j_base, j_recipe, j_cost, j_ctrl, JSched),
        "t": (t_base, t_recipe, t_cost, t_ctrl, TargetPrecisionSchedule)}


# ---------------------------------------------------------------------------
# Synthetic rows, in lockstep
# ---------------------------------------------------------------------------

def _make(pkg, settings, recipe, total, *, n_layers=2, target=None,
          preset="uniform", calibration=None):
    """One package's controller: ``settings`` a kwargs dict of
    ``ControllerSettings``, ``calibration`` a speed-factor table."""
    base, rec, cost, ctrl, sched = PKGS[pkg]
    if preset == "first_last_k":
        plan = rec.PrecisionPlan.first_last_k(rec.RECIPES[recipe], n_layers,
                                              k=1)
    else:
        plan = rec.PrecisionPlan.uniform(rec.RECIPES[recipe], n_layers)
    tgt = (rec.PrecisionPlan.uniform(rec.RECIPES[target], n_layers)
           if target else None)
    cfg = importlib.import_module(
        ("repro" if pkg == "j" else "repro_torch") + ".configs.tiny"
    ).CONFIG.replace(n_layers=n_layers)
    return ctrl.PrecisionController(
        sched(plan, total, target=tgt), base.ControllerSettings(**settings),
        dims=cost.ModelDims.from_config(cfg, seq_len=64),
        calibration=(cost.calibrate(calibration) if calibration else None))


def _restore(ctrl, state, step):
    """The trainer's rollback handshake on a controller."""
    attempts, backed_off = ctrl.rollbacks, ctrl.lr_scale
    ctrl.load_state(json.loads(state))
    ctrl.rollbacks = max(ctrl.rollbacks, attempts)
    ctrl.lr_scale = min(ctrl.lr_scale, backed_off)
    ctrl.begin_replay(step)


def _lockstep(make, rows, n_steps, *, ckpt_every=0, swap_at=None):
    """Drive the reference's and the port's controller (``make(pkg)``)
    over ``rows(step, visit)`` for ``n_steps`` observations, checking
    events, plans and state at every step.  A rollback restores the newest
    state saved at a ``ckpt_every`` boundary.  At observation ``swap_at``
    the controllers are replaced by fresh ones loaded from the JSON of
    the other package's state (and a third, the reference's own reload),
    which continue in lockstep.  Returns (all events, final state)."""
    ctrls = [make("j"), make("t")]
    saved, visits, events = {}, {}, []
    step = 0
    for n in range(n_steps):
        if n == swap_at:
            state = json.dumps(ctrls[0].state_dict())
            assert json.dumps(ctrls[1].state_dict()) == state
            ctrls = [make("j"), make("t"), make("j")]
            for c in ctrls:
                c.load_state(json.loads(state))
        visits[step] = visits.get(step, 0) + 1
        row = rows(step, visits[step])
        evs = [c.observe(step, dict(row)) for c in ctrls]
        assert all(e == evs[0] for e in evs), (step, evs)
        events += evs[0]
        s = step
        if any(e["event"] == "rollback" for e in evs[0]) and saved:
            back = max(saved)
            for c, st in zip(ctrls, saved[back]):
                _restore(c, st, back)
            step = back
        else:
            step += 1
        if ckpt_every and (s + 1) % ckpt_every == 0:
            saved[step] = [json.dumps(c.state_dict()) for c in ctrls]
        states = [json.dumps(c.state_dict()) for c in ctrls]
        assert all(st == states[0] for st in states), step
        for p in (step - 1, step, step + 1):
            plans = [c.active_plan(max(p, 0)).to_dict() for c in ctrls]
            assert all(pl == plans[0] for pl in plans), p
        assert len({c.lr_scale for c in ctrls}) == 1
    return events, ctrls[0].state_dict()


def _err_row(errs, loss=1.0, **extra):
    return {"loss": loss, **{f"tel/{c.split('/')[0]}/{c.split('/')[1]}"
                             f"/mm0/fwd_x/rel_err": v
                             for c, v in errs.items()}, **extra}


STORM = {"tel/l00/ffn/mm0/wgrad_x/clip": 0.5,
         "tel/bwd/l00/ffn/wgrad_g/clip": 0.6,
         "tel/l01/ffn/mm0/wgrad_x/clip": 0.0,
         "tel/l00/attn/mm0/wgrad_x/clip": 0.0}

# name -> (make kwargs, rows(step, visit), observations, lockstep kwargs,
# events that must appear); the reference's controller tests' rows
SCENARIOS = {
    "switch": (dict(settings=dict(switch_error_threshold=0.1,
                                  error_ema_decay=0.5),
                    recipe="paper_fp4", total=100),
               lambda s, v: _err_row({"l00/ffn": 0.3}), 10, {},
               {"switch"}),
    "fixed_fraction": (dict(settings={}, recipe="paper_fp4", total=20),
                       lambda s, v: _err_row({"l00/ffn": 0.9}), 22, {},
                       set()),
    "demote_cell": (dict(settings=dict(demote_overflow_threshold=0.2,
                                       demote_patience=3),
                         recipe="paper_fp4", total=100),
                    lambda s, v: {"loss": 1.0, **STORM}, 5, {}, {"demote"}),
    "demote_head": (dict(settings=dict(demote_overflow_threshold=0.2,
                                       demote_patience=2),
                         recipe="paper_fp4", total=100),
                    lambda s, v: {"loss": 1.0,
                                  "tel/head/mm0/wgrad_x/clip": 0.9,
                                  "tel/bwd/head/wgrad_g/clip": 0.7}, 3, {},
                    {"demote"}),
    "streak_broken": (dict(settings=dict(demote_overflow_threshold=0.2,
                                         demote_patience=3),
                           recipe="paper_fp4", total=100),
                      lambda s, v: {"loss": 1.0,
                                    "tel/l00/ffn/mm0/wgrad_x/clip":
                                    0.0 if s == 2 else 0.5}, 5, {}, set()),
    "demote_survives_switch": (
        dict(settings=dict(demote_overflow_threshold=0.2, demote_patience=2),
             recipe="paper_fp4", total=20, target="fine_grained_fp4"),
        lambda s, v: {"loss": 1.0, "tel/l00/ffn/mm0/wgrad_x/clip": 0.9},
        22, {}, {"demote"}),
    "spike_replay": (dict(settings=dict(spike_factor=2.0, spike_warmup=3,
                                        replay_steps=4, max_rollbacks=1),
                          recipe="paper_fp4", total=100),
                     lambda s, v: {"loss": {6: 5.0, 9: 50.0}.get(s, 1.0)
                                   if v == 1 else 1.0}, 16,
                     dict(ckpt_every=2), {"rollback"}),
    "lr_backoff": (dict(settings=dict(spike_factor=2.0, spike_warmup=3,
                                      replay_steps=0, max_rollbacks=4,
                                      lr_backoff=0.5,
                                      lr_recovery_steps=10),
                        recipe="paper_fp4", total=1000),
                   lambda s, v: {"loss": {6: 5.0, 20: 50.0}.get(s, 1.0)
                                 if v == 1 else 1.0}, 30,
                   dict(ckpt_every=5), {"rollback"}),
    "search_with_demotion": (
        dict(settings=dict(plan_search=True, plan_search_every=3,
                           demote_overflow_threshold=0.2,
                           demote_patience=2),
             recipe="all_fp4", total=1000),
        lambda s, v: _err_row({"l00/ffn": 0.3, "l01/ffn": 0.1},
                              **{"tel/l00/ffn/mm0/wgrad_x/clip": 0.9}),
        12, {}, {"demote", "plan_search", "frontier_point"}),
    "window_reset_in_replay": (
        dict(settings=dict(plan_search=True, plan_search_every=5,
                           demote_overflow_threshold=0.2, demote_patience=2,
                           spike_factor=2.0, spike_warmup=0,
                           replay_steps=5),
             recipe="all_fp4", total=1000),
        lambda s, v: _err_row({"l00/ffn": 0.3}, loss=(
            4.0 if (s, v) == (2, 1) else 1.0), **(
            {"tel/l00/ffn/mm0/wgrad_x/clip": 0.9}
            if s >= 2 and (s, v) != (2, 1) else {})),
        12, dict(ckpt_every=2), {"rollback", "demote"}),
}


@pytest.mark.parametrize("swap", [False, True])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_rows_lockstep(name, swap):
    make_kw, rows, n, kw, must = SCENARIOS[name]
    events, _ = _lockstep(lambda pkg: _make(pkg, **make_kw), rows, n,
                          swap_at=n // 2 if swap else None, **kw)
    assert must <= {e["event"] for e in events}, events


def _random_rows(seed, n_layers):
    """A seeded stream crossing every rule: per-cell forward errors that
    drift up (the error switch fires late), a noisy layer whose FFN wgrad
    clips for stretches (demotion with patience), head keys, occasional
    loss spikes (rollbacks, replay, LR backoff and recovery), and the
    errors of promoted cells dropping once the plan protects them (the
    searcher's moves, promotions and demotions)."""
    rng = np.random.default_rng(seed)
    base = {f"l{i:02d}/{c}": float(rng.uniform(0.02, 0.2))
            for i in range(n_layers) for c in ("attn", "ffn")}
    clip = rng.uniform(0, 1, (400, n_layers)) < 0.5
    spikes = {int(s) for s in rng.choice(np.arange(12, 60), 3,
                                         replace=False)}

    def rows(step, visit):
        r = {"loss": float(rng.uniform(2.0, 2.2) if not (
            step in spikes and visit == 1) else 9.0)}
        drift = 1.0 + 0.02 * step
        for cell, e in base.items():
            layer, cls = cell.split("/")
            e = float(e * drift * rng.uniform(0.9, 1.1))
            r[f"tel/{layer}/{cls}/mm0/fwd_x/rel_err"] = e
            r[f"tel/{layer}/{cls}/mm1/fwd_w/rel_err"] = e / 2
            r[f"tel/bwd/{layer}/{cls}/wgrad_g/rel_err"] = e / 3
            r[f"tel/bwd/{layer}/{cls}/taps"] = 2.0
        for i in range(n_layers):
            hot = i == 1 and clip[step % 400, i] or (i == 2 and step > 30)
            r[f"tel/l{i:02d}/ffn/mm0/wgrad_x/clip"] = float(
                rng.uniform(0.3, 0.5) if hot else rng.uniform(0, 0.05))
            r[f"tel/bwd/l{i:02d}/ffn/wgrad_g/clip"] = float(
                rng.uniform(0, 0.1))
        r["tel/head/mm0/fwd_x/rel_err"] = float(rng.uniform(0.01, 0.02))
        r["tel/bwd/head/wgrad_g/clip"] = float(rng.uniform(0, 0.01))
        r["tel/gnorm/l00"] = 1.0
        return r
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_controller_random_stream_lockstep(seed):
    """Every rule at once, on a 4-layer first_last_k all_fp4 plan with a
    measured calibration: the two packages agree event for event and
    state for state, across rollbacks and a cross-package reload."""
    n = 4
    settings = dict(switch_error_threshold=0.16, error_ema_decay=0.8,
                    demote_overflow_threshold=0.25, demote_patience=3,
                    spike_factor=2.0, spike_warmup=5, replay_steps=3,
                    max_rollbacks=3, lr_backoff=0.5, lr_recovery_steps=6,
                    plan_search=True, plan_search_every=4,
                    plan_search_max_edits=6, plan_search_cost_budget=0.62,
                    plan_search_demote_threshold=0.12)
    cal = {("fp4_e2m1@block", "fp4_e2m1@tile"): 0.06,
           ("fp8_e4m3@token", "fp8_e4m3@token"): 0.25,
           ("fp4_e2m1", "fp4_e2m1"): 0.05, ("bf16", "bf16"): 0.4}
    for calibration in (None, cal):
        events, state = _lockstep(
            lambda pkg: _make(pkg, settings, "all_fp4", 120, n_layers=n,
                              preset="first_last_k",
                              calibration=calibration),
            _random_rows(seed, n), 90, ckpt_every=4, swap_at=45)
        kinds = {e["event"] for e in events}
        assert {"switch", "demote", "rollback", "frontier_point",
                "plan_search"} <= kinds, kinds
        ops = {e["op"] for e in events if e["event"] == "plan_search"}
        if calibration is None:
            assert ops == {"promote", "demote"}, events
        assert state["rollbacks"] >= 1 and state["demoted"]


# -- the searcher alone (the reference's searcher tests' rows) --------------

START_ERRS = {"l00/ffn": 0.20, "l01/ffn": 0.15,
              "l00/attn": 0.10, "l01/attn": 0.05}


def _drive_searchers(settings, recipe, errs, steps, calibration=None):
    """Both packages' PlanSearcher on the same reacting rows (a promoted
    cell's error drops x1/8, a demoted one's rises x4), checked at every
    step; returns the reference's events and both searchers."""
    pair = []
    for pkg in "jt":
        base, rec, cost, ctrl, _ = PKGS[pkg]
        cfg = importlib.import_module(
            ("repro" if pkg == "j" else "repro_torch") + ".configs.tiny"
        ).CONFIG
        pair.append((ctrl.PlanSearcher(
            cost.ModelDims.from_config(cfg, seq_len=64),
            base.ControllerSettings(plan_search=True, **settings),
            calibration=(cost.calibrate(calibration) if calibration
                         else None)),
            rec.PrecisionPlan.uniform(rec.RECIPES[recipe], 2)))
    events = []
    for step in range(steps):
        row = _err_row(errs)
        evs = []
        for s, base_plan in pair:
            s.observe(step, dict(row))
            evs.append(s.maybe_move(step, base_plan))
        assert evs[0] == evs[1], step
        assert pair[0][0].state_dict() == pair[1][0].state_dict()
        assert pair[0][0].apply(pair[0][1]).to_dict() == \
            pair[1][0].apply(pair[1][1]).to_dict()
        for ev in evs[0]:
            events.append(ev)
            if ev["event"] == "plan_search":
                errs[ev["cell"]] *= 1 / 8 if ev["op"] == "promote" else 4.0
    return events, pair


@pytest.mark.parametrize("case", ["frontier", "budget_demote", "max_edits",
                                  "calibrated"])
def test_searcher_lockstep(case):
    settings, recipe, errs = dict(plan_search_every=3), "all_fp4", \
        dict(START_ERRS)
    cal = None
    if case == "budget_demote":
        recipe, errs = "fp8", {"l00/ffn": 0.04, "l01/ffn": 0.03,
                               "l00/attn": 0.02, "l01/attn": 0.01}
        dims = j_cost.ModelDims.from_config(
            importlib.import_module("repro.configs.tiny").CONFIG, seq_len=64)
        settings.update(plan_search_cost_budget=j_cost.plan_cost(
            j_recipe.PrecisionPlan.uniform(j_recipe.RECIPES["fp8"], 2),
            dims), plan_search_demote_threshold=0.5)
    elif case == "max_edits":
        settings.update(plan_search_max_edits=2)
    elif case == "calibrated":
        cal = {("fp4_e2m1", "fp4_e2m1"): 0.5, ("fp4_e2m1", "fp8_e4m3"): 0.5,
               ("fp4_e2m1", "fp8_e5m2"): 0.5, ("fp8_e4m3", "fp8_e4m3"): 3.0,
               ("fp8_e4m3", "fp8_e5m2"): 3.0, ("fp8_e5m2", "fp8_e5m2"): 3.0,
               ("bf16", "bf16"): 1.0}
    events, pair = _drive_searchers(settings, recipe, errs, 40, cal)
    s = pair[1][0]
    assert s.done
    costs = [p["cost"] for p in s.frontier]
    errors = [p["error"] for p in s.frontier]
    assert costs == sorted(costs) and errors == sorted(errors, reverse=True)
    ops = [e["op"] for e in events if e["event"] == "plan_search"]
    assert ops and ("demote" in ops) == (case == "budget_demote")


def _bits(t):
    return t.detach().numpy().tobytes()


def _demotion_trainer(ckdir, total=8):
    tcfg = importlib.import_module("repro_torch.configs.tiny").CONFIG \
        .replace(dtype="float32", n_layers=4)
    return Trainer(t_build(tcfg, "cpu"), t_base.TrainConfig(
        recipe="paper_fp4", plan_preset="first_last_k", plan_k=1,
        total_steps=total, global_batch=4, seq_len=64, learning_rate=3e-3,
        log_every=0, checkpoint_every=2, checkpoint_dir=str(ckdir),
        telemetry=True, controller=t_base.ControllerSettings(
            demote_overflow_threshold=0.2, demote_patience=2)),
        SyntheticLM(tcfg.vocab_size, 64, 4, seed=0))


def _force_demotion(tr, step):
    storm = {"loss": 1.0, "tel/l01/ffn/mm0/wgrad_x/clip": 0.9,
             "tel/bwd/l01/ffn/wgrad_g/clip": 0.9}
    events = tr.controller.observe(step, storm)
    events += tr.controller.observe(step, storm)
    assert [e["cell"] for e in events] == ["l01/ffn"]


@pytest.fixture
def one_thread():
    """One intra-op thread: ``tiny``'s ops gain nothing from more, and
    with several test workers on the machine every parallel region of
    thousands of tiny ops waits on descheduled threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(prev)


def test_depth_graded_demotion_resume_bit_exact(tmp_path, one_thread):
    """(c) first_last_k (k = 1) on 4 layers; the controller demotes layer
    1's FFN cell after step 2; a run stopped at step 6 (its checkpoints
    at 4 and 6 carry the demotion) and resumed by a fresh Trainer equals
    the uninterrupted run bit for bit across the §3.3 switch at 7."""
    ref = _demotion_trainer(tmp_path / "ref")
    state = ref.train(ref.init_state(), num_steps=3)
    _force_demotion(ref, 2)
    ref_final = ref.train(state)
    assert ref.history[2]["recipe"] == "paper_fp4+fl1"
    assert ref.history[3]["recipe"] == "paper_fp4+fl1+l01.ffn=fp8"
    assert ref.history[-1]["recipe"] == "bf16"
    dem = ref._active_plan(3).layers[1].ffn_linear
    assert dem.fwd_x == t_recipe.MM_FP8.fwd_x and dem.dgrad_g.is_passthrough
    assert ref._active_plan(3).layers[2].ffn_linear == \
        t_recipe.RECIPES["paper_fp4"].ffn_linear

    first = _demotion_trainer(tmp_path / "b")
    state = first.train(first.init_state(), num_steps=3)
    _force_demotion(first, 2)
    first.train(state, num_steps=3)              # stops at step 6
    second = _demotion_trainer(tmp_path / "b")
    resumed = second.resume()
    assert resumed.step == 6 and second.controller.demoted == ["l01/ffn"]
    assert second._active_plan(6).name == "paper_fp4+fl1+l01.ffn=fp8"
    final = second.train(resumed)
    keys = ("loss", "grad_norm", "recipe", "lr")
    assert [[r[k] for k in keys] for r in second.history] == \
        [[r[k] for k in keys] for r in ref.history[6:]]
    for a, b in zip(tree_leaves(final.params) + tree_leaves(
            final.opt_state.mu), tree_leaves(ref_final.params)
            + tree_leaves(ref_final.opt_state.mu)):
        assert _bits(a) == _bits(b)
    assert second.controller.state_dict() == ref.controller.state_dict()
