"""Training the cross-attention families in the port against the JAX
reference, on the CPU at ``REDUCED`` size (llama-3.2-vision-90b and
whisper-base, helpers and gates as ``tests/test_torch_cross.py``: every
``cross_gate`` at 1.0 on both sides, the reference unrolled, its Pallas
kernels in interpret mode):

* a 3-step vlm and a 2-step whisper ``Trainer`` run over a pipeline of
  seeded states (TRAIN_TOL, ``tests/test_torch_train.py``'s bars), and
  whisper's encoder moved by AdamW's weight decay alone, bit for bit;
* the routing census of one vlm training step, bitwise;
* the telemetry rows of one vlm step (``tests/test_torch_telemetry.py``'s
  bars: step 0's for the forward side, after-flip ones for the backward
  side) and of one whisper step (its encoder skipped; taps exact, the
  rest to step 0's bar).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import routing as j_routing  # noqa: E402
from repro.core.recipe import PrecisionPlan as JPlan  # noqa: E402
from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim.adamw import adamw as j_adamw  # noqa: E402
from repro.train import train_step as j_step  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import routing  # noqa: E402
from repro_torch.core.recipe import PrecisionPlan  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.train.train_step import make_optimizer  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from test_torch_cross import (AUDIO, BATCH, SEQ, VLM, _batch,  # noqa: E402
                              _cfgs, _np, _states, open_gates)
from torch_dist_workers import torch_threads as torch_threads  # noqa

# the Trainer bars of tests/test_torch_train.py
TRAIN_TOL = {"paper_fp4": dict(loss=1e-2, grad_norm=3e-2, params=1e-2),
             "bf16": dict(loss=1e-5, grad_norm=1e-5, params=1e-4)}
# forward-side telemetry floats, step 0 (same inputs on both sides)
TEL_TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass
class StatesPipeline:
    """``SyntheticLM`` batches (the package's own class) plus seeded
    ``vision`` / ``frames`` states of the config's shape."""

    lm: object
    cfg: object

    def batch(self, step: int):
        out = self.lm.batch(step)
        key, st = _states(self.cfg, b=out["tokens"].shape[0],
                          seed=1000 + step)
        out[key] = st
        return out


@pytest.mark.parametrize("name,recipe,steps", [(VLM, "bf16", 3),
                                               (AUDIO, "paper_fp4", 2)])
def test_trainer_matches_jax(name, recipe, steps):
    """f32, both impls "pallas" on the port's side, AdamW, a states
    pipeline, against the JAX ``Trainer`` from the same parameters:
    per-step loss, grad norm and LR, and the final parameters, within
    TRAIN_TOL.  The vlm runs the bf16 recipe (no quantizer: every kernel
    route, the open gates and the cross path held to f32 summation
    order); under paper_fp4 its step-1 loss read 1.1% apart (AdamW's
    first step moves each element by about lr times the sign of its
    gradient, and an FP4 flip upstream turns the sign of near-zero
    gradient elements: 2 x lr on those), as ``tests/test_torch_train.py``
    describes for ``tiny``.  whisper's encoder leaves get zero gradients:
    they equal, bit for bit, the reference's AdamW run op by op on zero
    gradients (weight decay alone), and their moments stay 0."""
    tol = TRAIN_TOL[recipe]
    over = dict(linear_impl="pallas", attention_impl="pallas")
    jcfg, tcfg = _cfgs(name, **over)
    kw = dict(recipe=recipe, total_steps=steps, global_batch=BATCH,
              seq_len=SEQ)
    jtr = JTrainer(j_build(jcfg), JTrainConfig(**kw), StatesPipeline(
        JSynthetic(jcfg.vocab_size, SEQ, BATCH, seed=0), jcfg))
    ttr = Trainer(t_build(tcfg, "cpu"), TrainConfig(**kw), StatesPipeline(
        SyntheticLM(tcfg.vocab_size, SEQ, BATCH, seed=0), tcfg))
    jstate = jtr.init_state()
    jstate = dataclasses.replace(jstate, params=open_gates(jstate.params))
    jenc0 = jstate.params.get("encoder")
    tstate = ttr.init_state(params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    jstate = jtr.train(jstate)
    tstate = ttr.train(tstate)
    for key, rtol in (("loss", tol["loss"]),
                      ("grad_norm", tol["grad_norm"]), ("lr", 1e-6)):
        np.testing.assert_allclose(
            [r[key] for r in ttr.history], [r[key] for r in jtr.history],
            rtol=rtol, err_msg=key)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg)
    for a, b in zip(tree_leaves(tstate.params), tree_leaves(ref)):
        np.testing.assert_allclose(_np(a), b.numpy(), rtol=0,
                                   atol=tol["params"])
    if name == AUDIO:
        opt, enc = j_adamw(weight_decay=0.1), jenc0
        st = opt.init(enc)
        zeros = jax.tree.map(jnp.zeros_like, enc)
        for row in jtr.history:
            enc, st = opt.update(zeros, st, enc, jnp.float32(row["lr"]))
        want = params_from_jax(jax.tree.map(np.asarray, {
            **jstate.params, "encoder": enc}), tcfg)["encoder"]
        for a, b in zip(tree_leaves(tstate.params["encoder"]),
                        tree_leaves(want)):
            np.testing.assert_array_equal(a.numpy().view(np.int32),
                                          b.numpy().view(np.int32))
        assert all(not bool(m.any()) for m in tree_leaves(
            tstate.opt_state.mu["encoder"]))


def test_vlm_step_census_matches_reference():
    """The routing census of one vlm training step (paper_fp4, both impls
    "pallas"): equal cells to the reference's trace of its step, the cross
    sublayer's fwd, dgrad and wgrad under layer 3's attn class."""
    over = dict(linear_impl="pallas", attention_impl="pallas")
    jcfg, tcfg = _cfgs(VLM, **over)
    jp = JPlan.uniform(J_RECIPES["paper_fp4"], jcfg.n_layers)
    tp = PrecisionPlan.from_dict(jp.to_dict())
    jm, tm = j_build(jcfg), t_build(tcfg, "cpu")
    params = open_gates(jm.init(jax.random.PRNGKey(0), jnp.float32))
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    jb, tb = _batch(tcfg)
    j_tcfg = JTrainConfig(total_steps=8, global_batch=BATCH, seq_len=SEQ)
    t_tcfg = TrainConfig(total_steps=8, global_batch=BATCH, seq_len=SEQ)
    fn = j_step.make_train_step(jm, j_tcfg, jp, jit=False, donate=False)
    with j_routing.capture() as jlog:
        jax.make_jaxpr(fn)(params, j_step.make_optimizer(jm, j_tcfg).init(
            params), jnp.zeros((), jnp.float32), jb,
            jnp.zeros((), jnp.int32), jnp.ones((), jnp.float32))
    step = make_train_step(tm, t_tcfg, tp)
    with routing.capture() as tlog:
        step(tparams, make_optimizer(tm, t_tcfg).init(tparams), None, tb,
             0)
    got, want = (sorted(log.to_dict()["cells"], key=repr)
                 for log in (tlog, jlog))
    assert got == want
    roles = {(c["layer"], c["cls"], c["role"]) for c in got}
    assert {(f"L{i}", "attn", r) for i in range(jcfg.n_layers)
            for r in ("fwd", "dgrad", "wgrad")} <= roles


def _telemetry_rows(name):
    """Step 0's history rows of one instrumented step (``telemetry=True``,
    paper_fp4, both impls "pallas") through both ``Trainer``s from the
    same parameters: (port's, reference's)."""
    over = dict(linear_impl="pallas", attention_impl="pallas")
    jcfg, tcfg = _cfgs(name, **over)
    kw = dict(recipe="paper_fp4", total_steps=1, global_batch=BATCH,
              seq_len=SEQ, telemetry=True)
    jtr = JTrainer(j_build(jcfg), JTrainConfig(**kw), StatesPipeline(
        JSynthetic(jcfg.vocab_size, SEQ, BATCH, seed=0), jcfg))
    ttr = Trainer(t_build(tcfg, "cpu"), TrainConfig(**kw), StatesPipeline(
        SyntheticLM(tcfg.vocab_size, SEQ, BATCH, seed=0), tcfg))
    jstate = jtr.init_state()
    jstate = dataclasses.replace(jstate, params=open_gates(jstate.params))
    tstate = ttr.init_state(params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    jtr.train(jstate)
    ttr.train(tstate)
    return ttr.history[0], jtr.history[0]


def test_vlm_telemetry_rows_match_reference():
    """One instrumented vlm step (``_telemetry_rows``): the same
    ``tel/...`` keys, the cross layer's among them; the forward-side
    stats within the step-0 bars of ``tests/test_torch_telemetry.py``
    (rates to 1e-6, the rest to TEL_TOL).  The backward-side stats and the
    gradient norms are held to that file's bars for a step after FP4
    flips (rtol 0.2 + atol 5e-3): below the cross layer the cotangents
    differ in f32 summation order (the cross sublayer's backward adds
    terms in another order), and FP4 / FP8 roundings of the gradient
    flip a grid step here and there (read: 1.6e-2 relative on layer 0's
    attn dgrad rel_err, 4.1e-4 on its gradient norm).  Taps exact."""
    tr, jr = _telemetry_rows(VLM)
    tel = sorted(k for k in jr if k.startswith("tel/"))
    assert tel and sorted(k for k in tr if k.startswith("tel/")) == tel
    assert any(k.startswith("tel/l03/cross/") for k in tel)
    for key in tel:
        got, ref = float(tr[key]), float(jr[key])
        stat = key.rsplit("/", 1)[1]
        if stat == "taps":
            assert got == ref, key
        elif key.startswith(("tel/bwd/", "tel/gnorm/")):
            np.testing.assert_allclose(got, ref, rtol=0.2, atol=5e-3,
                                       err_msg=key)
        elif stat in ("clip", "underflow"):
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, rtol=TEL_TOL, atol=1e-12,
                                       err_msg=key)
    np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-6)


def test_whisper_telemetry_rows_match_reference():
    """One instrumented whisper step (``_telemetry_rows``), the port's
    encoder skipped (the dead encoder): the same ``tel/...`` keys as the
    reference, whose ``_encode`` runs and drops its forward-side stats
    and folds its backward taps into the class rows (``indexed_probes=
    False``).  Tap counts exact, class rows included, so the reference's
    encoder adds no tap there either (its cotangent never reaches the
    encoder); every other stat within TEL_TOL (the decoder has no cross
    sublayer, so the cotangents meet no reordered sum)."""
    tr, jr = _telemetry_rows(AUDIO)
    tel = sorted(k for k in jr if k.startswith("tel/"))
    assert tel and sorted(k for k in tr if k.startswith("tel/")) == tel
    assert not any("/cross/" in k for k in tel)
    for key in tel:
        got, ref = float(tr[key]), float(jr[key])
        if key.endswith("/taps"):
            assert got == ref, key
        else:
            np.testing.assert_allclose(got, ref, rtol=TEL_TOL, atol=1e-12,
                                       err_msg=key)
    np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-6)
