"""The port's ``Trainer`` under the adaptive precision controller
against the JAX ``Trainer``, on ``tiny`` in f32 (``linear_impl="qdq"``,
the reference tests' default).

(a) plan search wiring, priced by a ``speed_factors.v1`` file the
    reference wrote: the same edits and plan names; frontier costs
    bitwise (the same plans priced on the same dims and table), frontier
    errors within FRONTIER_RTOL;
(b) rollback, on top of (a)'s run: the restore equals the checkpoint
    bit for bit in fresh storage, the replay runs bf16, and each row's ``lr`` is the port's
    scheduled f32 LR times the f32 scale exactly, equal to the
    reference's schedule (op by op) times it, and within one f32 ulp of
    the JAX row (XLA's fused f32 cosine differs from libm's in the last
    bit at some steps; the scale itself is exact on both sides);
(d) each package's ``Trainer`` resumes the other's checkpoint with its
    controller state: equal ``state_dict()`` and active plan.
"""
import copy
import importlib
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.configs import base as j_base  # noqa: E402
from repro.core import cost_model as j_cost  # noqa: E402
from repro.core import recipe as j_recipe  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim.schedule import warmup_cosine as j_warmup  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs import base as t_base  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.optim.schedule import warmup_cosine  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

# (a): frontier errors are means of the telemetry rows' rel_err over a
# window of training steps.  Port and reference start from the same
# params but differ by f32 summation order, which flips an FP4 rounding
# now and then and carries on through the updates (the trainer bar of
# test_torch_train, 1e-2 on losses under FP4); measured: 2.5e-4 on the
# first window, 1.2e-3 on the second.
FRONTIER_RTOL = 1e-2


def _cfgs(**over):
    kw = dict(dtype="float32", **over)
    return (importlib.import_module("repro.configs.tiny").CONFIG.replace(
        **kw), importlib.import_module("repro_torch.configs.tiny").CONFIG
        .replace(**kw))


def _trainers(ckdir_j, ckdir_t, *, cfg_over=None, **tkw):
    """A JAX and a port Trainer on the same tiny config, TrainConfig and
    seeded data; the port starts from the reference's initial params."""
    jcfg, tcfg = _cfgs(**(cfg_over or {}))
    ctl = tkw.pop("controller")
    common = dict(global_batch=8, seq_len=64, learning_rate=3e-3,
                  log_every=0, **tkw)
    jtr = JTrainer(j_build(jcfg), j_base.TrainConfig(
        checkpoint_dir=str(ckdir_j), controller=j_base.ControllerSettings(
            **ctl), **common), JSynthetic(jcfg.vocab_size, 64, 8, seed=0))
    ttr = Trainer(t_build(tcfg, "cpu"), t_base.TrainConfig(
        checkpoint_dir=str(ckdir_t), controller=t_base.ControllerSettings(
            **ctl), **common), SyntheticLM(tcfg.vocab_size, 64, 8, seed=0))
    jstate = jtr.init_state()
    tstate = ttr.init_state(params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    return jtr, jstate, ttr, tstate


SEARCH = dict(recipe="all_fp4", total_steps=100, telemetry=True,
              checkpoint_every=4,
              controller=dict(plan_search=True, plan_search_every=3,
                              plan_search_max_edits=1, replay_steps=2,
                              lr_backoff=0.5, lr_recovery_steps=4))
# a measured-looking table (fp4 still faster than fp8), written by the
# reference's CostCalibration and read by both Trainers
SEARCH_FACTORS = {("fp4_e2m1", "fp4_e2m1"): 3.0,
                  ("fp8_e4m3@token", "fp8_e4m3@token"): 1.5,
                  ("fp8_e5m2", "fp8_e4m3"): 1.25}


def _search_kw(root):
    path = str(root / "speed_factors.json")
    j_cost.calibrate(SEARCH_FACTORS, source="test").to_json(path)
    return dict(copy.deepcopy(SEARCH), cost_calibration=path)


def _bits(t):
    return t.detach().numpy().tobytes()


def _leaves(state):
    return (tree_leaves(state.params) + tree_leaves(state.opt_state.mu)
            + tree_leaves(state.opt_state.nu))


@pytest.fixture(scope="module")
def search_run(tmp_path_factory):
    """The reference's plan-search wiring run, 8 steps, in both packages,
    priced by a speed-factor file; with what the tests read at step 8
    (the tests that train on keep the trainers)."""
    root = tmp_path_factory.mktemp("search")
    jtr, jstate, ttr, tstate = _trainers(root / "j", root / "t",
                                         **_search_kw(root))
    jstate = jtr.train(jstate, num_steps=8)
    tstate = ttr.train(tstate, num_steps=8)
    at8 = {k: {"history": [dict(r) for r in tr.history],
               "events": [dict(e) for e in tr.controller.events],
               "state": copy.deepcopy(tr.controller.state_dict()),
               "plan": tr._active_plan(8).to_dict()}
           for k, tr in (("j", jtr), ("t", ttr))}
    return dict(root=root, j=(jtr, jstate), t=(ttr, tstate), at8=at8,
                t_bits=[_bits(x) for x in _leaves(tstate)])


def test_trainer_plan_search_matches_reference(search_run):
    """(a) The searcher edits the live plan the same way in both: equal
    edits, events and history plan names; frontier costs bitwise (priced
    by the same calibration file), errors within FRONTIER_RTOL."""
    jtr, ttr = search_run["j"][0], search_run["t"][0]
    j8, t8 = search_run["at8"]["j"], search_run["at8"]["t"]
    assert dict(ttr.calibration.table) == dict(jtr.calibration.table) == \
        SEARCH_FACTORS
    js, ts = j8["state"]["plan_search"], t8["state"]["plan_search"]
    assert ts["edits"] == js["edits"] and len(ts["edits"]) == 1
    assert ts["edits"][0][0] == "promote" and ts["done"]
    names = [r["recipe"] for r in t8["history"]]
    assert names == [r["recipe"] for r in j8["history"]]
    assert names[0] == "all_fp4" and "=fp8" in names[-1]
    assert [(e["event"], e["step"], e.get("cell"), e.get("plan"))
            for e in t8["events"]] == \
        [(e["event"], e["step"], e.get("cell"), e.get("plan"))
         for e in j8["events"]]
    tf, jf = ts["frontier"], js["frontier"]
    assert [p["cost"] for p in tf] == [p["cost"] for p in jf]
    assert [p["plan"] for p in tf] == [p["plan"] for p in jf]
    np.testing.assert_allclose([p["error"] for p in tf],
                               [p["error"] for p in jf], rtol=FRONTIER_RTOL)
    assert len(tf) == 2
    assert tf[1]["cost"] > tf[0]["cost"] and tf[1]["error"] < tf[0]["error"]
    assert t8["plan"] == j8["plan"]
    for p in jf:
        plan = j_recipe.PrecisionPlan.uniform(j_recipe.RECIPES["all_fp4"], 2)
        for op, cell in p["edits"]:
            plan = plan.promote(cell.split("/")[1], layer=int(cell[1:3]))
        assert p["cost"] == j_cost.plan_cost(plan, jtr.dims,
                                             jtr.calibration)


@pytest.mark.parametrize("reader", ["port_reads_jax", "jax_reads_port"])
def test_trainer_resumes_other_package_controller(search_run, tmp_path,
                                                  reader):
    """(d) A Trainer of one package resumes the step-8 checkpoint the
    other's wrote, with its controller and searcher state: equal
    ``state_dict()`` and active plan."""
    src = search_run["root"] / ("j" if reader == "port_reads_jax" else "t")
    at8 = search_run["at8"]["j" if reader == "port_reads_jax" else "t"]
    shutil.copytree(src / "step_00000008", tmp_path / "step_00000008")
    jcfg, tcfg = _cfgs()
    tkw = _search_kw(tmp_path)
    ctl = tkw.pop("controller")
    common = dict(global_batch=8, seq_len=64, learning_rate=3e-3,
                  log_every=0, checkpoint_dir=str(tmp_path), **tkw)
    if reader == "port_reads_jax":
        fresh = Trainer(t_build(tcfg, "cpu"), t_base.TrainConfig(
            controller=t_base.ControllerSettings(**ctl), **common),
            SyntheticLM(tcfg.vocab_size, 64, 8, seed=0))
    else:
        fresh = JTrainer(j_build(jcfg), j_base.TrainConfig(
            controller=j_base.ControllerSettings(**ctl), **common),
            JSynthetic(jcfg.vocab_size, 64, 8, seed=0))
    state = fresh.resume()
    assert state is not None and state.step == 8
    assert fresh.controller.state_dict() == at8["state"]
    assert fresh._active_plan(8).to_dict() == at8["plan"]


def test_trainer_rollback_matches_reference(search_run):
    """(b) A rollback injected after step 7 (as the reference's tests
    inject it): the port restores the step-8 checkpoint bit for bit into
    fresh storage; both replay steps 8-9 at bf16, then run step 10 on the
    searcher's plan; each row's lr is the scheduled f32 LR times the f32
    LR scale (0.5, then recovering by 2^(1/4) a step)."""
    runs = []
    for k in ("j", "t"):
        tr, state = search_run[k]
        ev = {"event": "rollback", "step": 7, "loss": 9.0, "loss_ema": 1.0}
        tr.controller.rollbacks = 1
        tr.controller._observe_lr([ev])
        restored = tr._apply_controller_events(state, [ev], lambda s: None)
        assert restored.step == 8 and tr.controller.replay_until == 10
        assert tr.controller.lr_scale == 0.5
        if k == "t":
            after = _leaves(restored)
            assert [_bits(a) for a in after] == search_run["t_bits"]
            running = {t.untyped_storage().data_ptr()
                       for t in _leaves(state)}
            assert not running & {t.untyped_storage().data_ptr()
                                  for t in after}
        tr.train(restored, num_steps=3)
        runs.append(tr.history[8:])
    jrows, trows = runs
    assert [r["step"] for r in trows] == [8, 9, 10]
    assert [r["recipe"] for r in trows] == [r["recipe"] for r in jrows]
    assert [r["recipe"] for r in trows][:2] == ["bf16", "bf16"]
    assert "=fp8" in trows[2]["recipe"]
    sched = warmup_cosine(3e-3, 100)
    j_sched = j_warmup(3e-3, 100)
    rate = (1.0 / 0.5) ** (1.0 / 4)
    scale = 0.5
    for tr_row, j_row in zip(trows, jrows):
        s = tr_row["step"]
        want = float(sched(s) * torch.tensor(scale, dtype=torch.float32))
        assert tr_row["lr"] == want
        assert want == float(np.float32(np.asarray(j_sched(s)))
                             * np.float32(scale))
        assert abs(tr_row["lr"] - j_row["lr"]) <= float(
            np.spacing(np.float32(want)))
        scale = min(1.0, scale * rate)
    assert trows[0]["lr"] == float(sched(8)) * 0.5
    jc, tc = (search_run[k][0].controller.state_dict() for k in "jt")
    assert tc["lr_scale"] == jc["lr_scale"] and \
        tc["replay_until"] == jc["replay_until"] == 10
