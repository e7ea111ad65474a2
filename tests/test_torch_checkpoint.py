"""The port's checkpoints against the JAX reference's, on the CPU.

Bars: a round trip is bitwise; the port restores a checkpoint the JAX
``CheckpointManager`` wrote, and the JAX side one the port wrote,
bitwise (the same ``step_<N>/arrays.npz`` + ``manifest.json`` layout and
key strings); retention and the skipping of incomplete directories give
the reference's step lists; an asynchronous save holds the values of the
moment it was called; a ``tiny`` run resumed at step 4 equals its
uninterrupted run bit for bit (f32, paper_fp4, across the §3.3 switch at
step 7), and the JAX ``Trainer`` resumed from the port's step-4
checkpoint runs on within the trainer bars of ``test_torch_train``.
"""
import importlib
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.checkpoint import manager as j_ckpt  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.checkpoint import manager as t_ckpt  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import opt_state_from_jax  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

OVER = dict(dtype="float32", linear_impl="pallas", attention_impl="pallas")
# test_torch_train.TRAIN_TOL["paper_fp4"]
TOL = dict(loss=1e-2, params=1e-2)


def _cfgs(**over):
    kw = {**OVER, **over}
    return (importlib.import_module("repro.configs.tiny").CONFIG.replace(
        **kw), importlib.import_module("repro_torch.configs.tiny").CONFIG
        .replace(**kw))


def _bits(t):
    return t.detach().numpy().tobytes()


def _jax_state(jcfg, steps=2):
    """Reference params and AdamW state after ``steps`` updates (nonzero
    moments, count == steps)."""
    model = j_build(jcfg)
    params = model.init(jax.random.PRNGKey(0), jnp.float32)
    opt = j_adamw()
    st = opt.init(params)
    for i in range(steps):
        g = jax.tree.map(lambda p: jnp.full_like(p, 0.01 * (i + 1)), params)
        params, st = opt.update(g, st, params, jnp.float32(1e-3))
    return params, st


def test_roundtrip_bitwise(tmp_path):
    """Nested dicts, lists, a NamedTuple with a Python count, f32 and
    bf16 leaves."""
    g = torch.Generator().manual_seed(0)
    tree = {"params": {"a": torch.randn(3, 5, generator=g),
                       "layers": [{"w": torch.randn(4, generator=g)}]},
            "opt_state": AdamWState(7, [torch.randn(2, 2, generator=g)],
                                    [torch.randn(2, 2, generator=g)
                                     .to(torch.bfloat16)]),
            "comp_state": torch.zeros(())}
    t_ckpt.save_pytree(tree, str(tmp_path / "x"), {"note": 1})
    back = t_ckpt.load_pytree(str(tmp_path / "x"), tree)
    assert back["opt_state"].count == 7
    assert isinstance(back["opt_state"], AdamWState)
    for a, b in zip(tree_leaves(tree["params"]) + [tree["comp_state"]],
                    tree_leaves(back["params"]) + [back["comp_state"]]):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    for a, b in zip(tree["opt_state"][1:], back["opt_state"][1:]):
        assert a[0].dtype == b[0].dtype
        assert torch.equal(a[0].view(-1), b[0].view(-1))
    assert t_ckpt.load_manifest(str(tmp_path / "x"))["extra"] == {"note": 1}


def test_port_restores_jax_checkpoint(tmp_path):
    """A checkpoint the reference's ``CheckpointManager`` wrote (its
    params, ``AdamWState`` and zero ``comp_state``), restored by the port's
    ``Trainer.resume`` and by ``CheckpointManager.restore``: bitwise equal
    to the same state carried across in memory (``params_from_jax``,
    ``opt_state_from_jax``)."""
    jcfg, tcfg = _cfgs()
    params, st = _jax_state(jcfg)
    tree = {"params": params, "opt_state": st,
            "comp_state": jnp.zeros((), jnp.float32)}
    j_ckpt.CheckpointManager(str(tmp_path)).save(6, tree,
                                                 extra={"recipe": "x"})
    want_p = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    want_o = opt_state_from_jax(jax.tree.map(np.asarray, st), tcfg)
    trainer = t_build(tcfg, "cpu")
    tr = _trainer(tcfg, checkpoint_every=2, checkpoint_dir=str(tmp_path),
                  model=trainer)
    state = tr.resume()
    assert state.step == 6 and state.opt_state.count == 2
    for a, b in zip(tree_leaves(state.params) + tree_leaves(
            state.opt_state.mu) + tree_leaves(state.opt_state.nu),
            tree_leaves(want_p) + tree_leaves(want_o.mu)
            + tree_leaves(want_o.nu)):
        assert _bits(a) == _bits(b)


def test_jax_restores_port_checkpoint(tmp_path):
    """A checkpoint the port wrote, restored by the reference's
    ``load_pytree`` against its own state structure: bitwise; the
    manifest's step and plan are the reference's fields."""
    jcfg, tcfg = _cfgs()
    params, st = _jax_state(jcfg)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    topt = opt_state_from_jax(jax.tree.map(np.asarray, st), tcfg)
    tr = _trainer(tcfg, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    from repro_torch.train.trainer import TrainState
    tr.save(TrainState(tparams, topt, torch.zeros(()), 4))
    like = {"params": params, "opt_state": st,
            "comp_state": jnp.zeros((), jnp.float32)}
    mgr = j_ckpt.CheckpointManager(str(tmp_path))
    restored, extra = mgr.restore(like)
    assert extra["step"] == 4 and extra["recipe"] == "paper_fp4"
    assert extra["plan"]["name"] == "paper_fp4"
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(like)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


def test_retention_and_incomplete_dirs(tmp_path):
    """Saves 1-5 under keep=2 leave the newest two on both sides; a step
    directory without a manifest (a crash mid-save) is skipped."""
    steps = {}
    for name, mod, leaf in (("j", j_ckpt, jnp.ones(3)),
                            ("t", t_ckpt, torch.ones(3))):
        d = tmp_path / name
        mgr = mod.CheckpointManager(str(d), keep=2)
        for s in range(1, 6):
            mgr.save(s, {"w": leaf})
        os.makedirs(d / "step_00000009")
        (d / "step_bad").mkdir()
        steps[name] = (mgr.all_steps(), mgr.latest_step())
    assert steps["t"] == steps["j"] == ([4, 5], 5)
    with pytest.raises(FileNotFoundError):
        t_ckpt.CheckpointManager(str(tmp_path / "empty")).restore({})


def test_async_save_copies_before_return(tmp_path):
    """The port's AdamW updates in place: an asynchronous save must hold
    the values of the moment ``save`` was called, not later ones."""
    mgr = t_ckpt.CheckpointManager(str(tmp_path), async_save=True)
    w = torch.arange(1 << 16, dtype=torch.float32)
    want = w.clone()
    mgr.save(1, {"w": w})
    w.add_(1.0)                      # the next step, in place
    mgr.wait()
    got, extra = mgr.restore({"w": w})
    assert extra["step"] == 1 and torch.equal(got["w"], want)


def _trainer(tcfg, model=None, **kw):
    from repro_torch.train.trainer import Trainer
    return Trainer(model or t_build(tcfg, "cpu"), TrainConfig(
        recipe="paper_fp4", total_steps=8, global_batch=2, seq_len=128,
        **kw), SyntheticLM(tcfg.vocab_size, 128, 2, seed=0))


def test_resume_matches_uninterrupted_run(tmp_path):
    """``tiny`` f32 under paper_fp4 for 8 steps: saved at step 4 (async),
    a second ``Trainer`` resumes from it and runs steps 4-7 across the
    switch at step 7.  Per-step losses, grad norms and plans and the final
    parameters and moments equal the uninterrupted run's bit for bit.
    Then the JAX ``Trainer`` resumes from the same step-4 checkpoint and
    runs on within the trainer bars (FP4 flips apart, the same run)."""
    _, tcfg = _cfgs()
    full = _trainer(tcfg)
    s_full = full.train(full.init_state(seed=0))
    ck = dict(checkpoint_every=4, checkpoint_dir=str(tmp_path),
              async_checkpoint=True)
    first = _trainer(tcfg, **ck)
    first.train(first.init_state(seed=0), num_steps=4)
    second = _trainer(tcfg, **ck)
    s_res = second.train()                # resume() inside
    assert second.schedule.switch_step == 7
    rows = first.history + second.history
    assert [r["step"] for r in rows] == list(range(8))
    for key in ("loss", "grad_norm", "recipe"):
        assert [r[key] for r in rows] == [r[key] for r in full.history], key
    assert [r["recipe"] for r in rows] == ["paper_fp4"] * 7 + ["bf16"]
    assert s_res.step == 8 and s_res.opt_state.count == 8
    for a, b in zip(tree_leaves(s_res.params) + tree_leaves(
            s_res.opt_state.mu), tree_leaves(s_full.params) + tree_leaves(
            s_full.opt_state.mu)):
        assert _bits(a) == _bits(b)
    # the reference's Trainer on the port's step-4 checkpoint (it keeps
    # step 8 of the port's run as its newest, so point it at a copy)
    import shutil
    jdir = tmp_path / "jax"
    shutil.copytree(tmp_path / "step_00000004", jdir / "step_00000004")
    jcfg, _ = _cfgs()
    jtr = JTrainer(j_build(jcfg), JTrainConfig(
        recipe="paper_fp4", total_steps=8, global_batch=2, seq_len=128,
        checkpoint_every=4, checkpoint_dir=str(jdir)),
        JSynthetic(jcfg.vocab_size, 128, 2, seed=0))
    j_state = jtr.train()
    assert [r["step"] for r in jtr.history] == [4, 5, 6, 7]
    assert [r["recipe"] for r in jtr.history] == \
        [r["recipe"] for r in second.history]
    np.testing.assert_allclose([r["loss"] for r in jtr.history],
                               [r["loss"] for r in second.history],
                               rtol=TOL["loss"])
    ref = params_from_jax(jax.tree.map(np.asarray, j_state.params), tcfg)
    for a, b in zip(tree_leaves(s_res.params), tree_leaves(ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=TOL["params"])
