"""The port's SSM family (mamba2-780m) and the hybrid stack (jamba-1.5-
large-398b) against the JAX reference, on the CPU, at ``REDUCED`` size:
configs and layer specs, the SSD core, the mamba mixer (training,
prefill, decode, gradients), the whole model's loss and gradients, a
short ``Trainer`` run, the cost model, and the reference's NaN gradient
that the port does not share.

The JAX side runs unrolled (``scan_layers=False``; its Pallas kernels in
interpret mode); the port runs the CUDA kernels' plain versions on CPU
tensors; weights come across through ``convert.params_from_jax``.  Inputs
are drawn with numpy seeds.  Bars:

* bitwise: config fields, layer specs, scan periods, cost-model dims and
  parameter counts;
* SSD (f32): max |diff| / max |ref| <= SSD_TOL against the reference's
  ``ssd_chunked`` and its sequential ``ssd_reference`` (summation order
  only);
* mixer and model: f32 forward and decode SSD_TOL-level; gradients and
  losses under ``GRAD_TOL`` (f32 summation order under bf16; FP4 / FP8
  rounding flips under paper_fp4, as ``tests/test_torch_moe.py`` states);
* the ``Trainer``: ``TRAIN_TOL``, as the MoE slice's.
"""
import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import MambaSettings as JMamba  # noqa: E402
from repro.core.cost_model import ModelDims as JDims  # noqa: E402
from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402
from repro.nn.params import init_params as j_init  # noqa: E402
from repro.optim.adamw import adamw as j_adamw  # noqa: E402
from repro.train.trainer import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs.base import MambaSettings, ModelConfig  # noqa: E402
from repro_torch.configs.base import TrainConfig, get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import ModelDims as TDims  # noqa: E402
from repro_torch.core.recipe import RECIPES as T_RECIPES  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.nn.params import init_params as t_init  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

ARCHS = ("mamba2_780m", "jamba_1_5_large_398b")
# max |diff| / max |ref|, f32: the SSD's and the mixer's summation order
SSD_TOL = 1e-5
# loss rtol, and a gradient leaf's max |diff| / max |ref|
GRAD_TOL = {"bf16": (1e-5, 1e-4), "paper_fp4": (1e-5, 2e-2)}
TRAIN_TOL = {"loss": 1e-4, "grad_norm": 1e-3, "params": 1e-4}


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def _modules(name):
    return (importlib.import_module(f"repro.configs.{name}"),
            importlib.import_module(f"repro_torch.configs.{name}"))


def _cfgs(name, **over):
    jm, tm = _modules(name)
    over = dict(dict(dtype="float32", scan_layers=False), **over)
    return jm.REDUCED.replace(**over), tm.REDUCED.replace(**over)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


# ---------------------------------------------------------------------------
# Configs and the cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_jax(name):
    """CONFIG and REDUCED field for field, the layer specs (mamba with no
    FFN; jamba's attention at i % 8 == 4 and MoE on odd layers) and the
    scan period equal the reference's."""
    jm, tm = _modules(name)
    for what in ("CONFIG", "REDUCED"):
        jc, tc = getattr(jm, what), getattr(tm, what)
        assert [f.name for f in dataclasses.fields(tc)] == \
            [f.name for f in dataclasses.fields(jc)]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), what
        assert [dataclasses.astuple(s) for s in tc.layer_specs()] == \
            [dataclasses.astuple(s) for s in jc.layer_specs()]
        assert tc.scan_period() == jc.scan_period()
    assert get_config(jm.CONFIG.name) == tm.CONFIG
    assert tm.SKIP_CELLS == jm.SKIP_CELLS
    assert [f.name for f in dataclasses.fields(MambaSettings)] == \
        [f.name for f in dataclasses.fields(JMamba)]
    d = dataclasses.asdict(jm.CONFIG)
    d["mamba"] = MambaSettings(**d["mamba"])
    if d["moe"] is not None:
        d["moe"] = type(tm.CONFIG.moe)(**d["moe"])
    assert ModelConfig(**d) == tm.CONFIG


@pytest.mark.parametrize("name", ARCHS)
def test_cost_model_dims_and_param_counts(name):
    """``ModelDims.from_config`` (mamba projections priced FFN-class) and
    the total / active parameter counts equal the reference's exactly,
    at full and reduced size."""
    jm, tm = _modules(name)
    for what in ("CONFIG", "REDUCED"):
        jc, tc = getattr(jm, what), getattr(tm, what)
        assert dataclasses.astuple(TDims.from_config(tc, 2048)) == \
            dataclasses.astuple(JDims.from_config(jc, 2048))
        jmod, tmod = j_build(jc), t_build(tc, "cpu")
        assert tmod.param_count() == jmod.param_count()
        assert tmod.active_param_count() == jmod.active_param_count()


def test_mamba_inits_follow_the_reference():
    """``a_log`` draws A in [1, 16) and ``dt_bias`` the inverse softplus
    of a log-uniform step in [1e-3, 1e-1] (the port's own generator, so
    the reference's distribution, not its draws); the f32 leaves keep
    their dtype through ``cast_params``."""
    _, tcfg = _cfgs("mamba2_780m", n_layers=4)
    specs = t_ssm.mamba_param_specs(tcfg.replace(d_model=512))
    p = t_init(specs, seed=0)
    a = torch.exp(p["a_log"])
    assert p["a_log"].dtype == torch.float32
    assert float(a.min()) >= 1.0 and float(a.max()) < 16.0
    dt = t_ssm.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    model = t_build(tcfg.replace(dtype="bfloat16"), "cpu")
    cast = model.cast_params(model.init(0))
    mix = cast["stack"]["layers"][0]["mixer"]
    assert {k for k, v in mix.items() if v.dtype == torch.float32} == \
        {"dt_bias", "a_log", "d_skip"}


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _ssd_inputs(b=2, s=64, h=4, p=8, n=16, g=2, seed=0, dta=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)).astype(
        np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    if dta is not None:        # dt * |A| = dta at every step
        dt = np.full((b, s, h), 0.1, np.float32)
        a = np.full(h, -dta / 0.1, np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, dt, a, bm, cm, s0


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_jax(chunk):
    """``ssd_chunked`` with an initial state against the reference's (and
    its sequential oracle), y and the final state."""
    x, dt, a, bm, cm, s0 = _ssd_inputs()
    jy, js = j_ssm.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm)),
                               chunk=chunk, initial_state=jnp.asarray(s0))
    ry, rs = j_ssm.ssd_reference(*map(jnp.asarray, (x, dt, a, bm, cm)),
                                 initial_state=jnp.asarray(s0))
    ty, ts = t_ssm.ssd_chunked(*map(_t, (x, dt, a, bm, cm)), chunk=chunk,
                               initial_state=_t(s0))
    oy, os_ = t_ssm.ssd_reference(*map(_t, (x, dt, a, bm, cm)),
                                  initial_state=_t(s0))
    for got, want in ((ty, jy), (ts, js), (ty, ry), (ts, rs), (oy, ry),
                      (os_, rs)):
        assert _rel(_np(got), np.asarray(want)) <= SSD_TOL


def test_reference_ssd_gradient_is_nan_where_the_ports_is_finite():
    """Reference property 1 (``repro/models/ssm.py:125-126``): at chunk
    64 with dt * |A| = 1.6 a step, the masked upper triangle's exp(seg)
    overflows to inf and the reference's dt gradient is NaN; the port's
    (mask before the exp) is finite and within 1e-4 (max |diff| / max
    |ref|) of an f64 sequential oracle's."""
    x, dt, a, bm, cm, _ = _ssd_inputs(s=128, h=2, dta=1.6)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def j_loss(dt_):
        y, _ = j_ssm.ssd_chunked(jnp.asarray(x), dt_, jnp.asarray(a),
                                 jnp.asarray(bm), jnp.asarray(cm), chunk=64)
        return jnp.sum(y * w)
    jg = np.asarray(jax.grad(j_loss)(jnp.asarray(dt)))
    assert np.isnan(jg).any()

    def t_grad(fn, dtype):
        dt_t = torch.tensor(dt, dtype=dtype, requires_grad=True)
        y, _ = fn(*[torch.tensor(v, dtype=dtype) for v in (x,)], dt_t,
                  *[torch.tensor(v, dtype=dtype) for v in (a, bm, cm)])
        (y * torch.tensor(w, dtype=dtype)).sum().backward()
        return dt_t.grad.numpy()
    got = t_grad(lambda *v: t_ssm.ssd_chunked(*v, chunk=64), torch.float32)
    want = t_grad(lambda *v: t_ssm.ssd_reference(*v, dtype=torch.float64),
                  torch.float64)
    assert np.isfinite(got).all()
    assert _rel(got, want) <= 1e-4


# ---------------------------------------------------------------------------
# The mixer
# ---------------------------------------------------------------------------

def _mixer_params(cfg_j, cfg_t, seed=0):
    jp = j_init(jax.random.PRNGKey(seed), j_ssm.mamba_param_specs(cfg_j))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("recipe", ["bf16", "paper_fp4"])
def test_mixer_forward_prefill_decode_and_grads_match_jax(recipe):
    """mamba2 ``REDUCED`` mixer, f32: the training forward and the
    gradients of the input and of every leaf; a 32-token prefill onto an
    empty cache then 8 decode steps (output, conv history and state)."""
    loss_tol, grad_tol = GRAD_TOL[recipe]
    jcfg, tcfg = _cfgs("mamba2_780m")
    jp, tp = _mixer_params(jcfg, tcfg)
    jr, tr = J_RECIPES[recipe].ffn_linear, T_RECIPES[recipe].ffn_linear
    x = (np.random.default_rng(1).standard_normal((2, 40, jcfg.d_model))
         * 0.5).astype(np.float32)

    def j_fwd(p, v):
        return j_ssm.mamba_mixer(p, jcfg, v, jr)[0]

    cot = np.random.default_rng(2).standard_normal(
        (2, 40, jcfg.d_model)).astype(np.float32)

    @jax.jit
    def j_fwd_vjp(p, v, c):
        y, vjp = jax.vjp(j_fwd, p, v)
        return y, vjp(c)
    jy, (jgp, jgx) = j_fwd_vjp(jp, jnp.asarray(x), jnp.asarray(cot))
    for v in tp.values():
        v.requires_grad_(True)
    xt = _t(x).requires_grad_(True)
    ty = t_ssm.mamba_mixer(tp, tcfg, xt, tr)
    assert _rel(_np(ty), np.asarray(jy)) <= (
        SSD_TOL if recipe == "bf16" else grad_tol)
    grads = torch.autograd.grad(ty, [xt, *tp.values()], _t(cot))
    assert _rel(_np(grads[0]), np.asarray(jgx)) <= grad_tol
    for (k, _), g in zip(tp.items(), grads[1:]):
        assert _rel(_np(g), np.asarray(jgp[k])) <= grad_tol, k

    with torch.no_grad():
        tp = {k: v.detach() for k, v in tp.items()}
        jc = j_ssm.init_mamba_cache(jcfg, 2, dtype=jnp.float32)
        tc = t_ssm.init_mamba_cache(tcfg, 2, torch.float32, "cpu")
        j_step = {d: jax.jit(lambda p, v, c, d=d: j_ssm.mamba_mixer(
            p, jcfg, v, jr, cache=c, decode=d)) for d in (False, True)}
        jo, jc = j_step[False](jp, jnp.asarray(x[:, :32]), jc)
        to = t_ssm.mamba_mixer(tp, tcfg, _t(x[:, :32]), tr, cache=tc)
        outs = [(to, jo)]
        for t in range(32, 40):
            jo, jc = j_step[True](jp, jnp.asarray(x[:, t:t + 1]), jc)
            to = t_ssm.mamba_mixer(tp, tcfg, _t(x[:, t:t + 1]), tr,
                                   cache=tc, decode=True)
            outs.append((to, jo))
        bar = SSD_TOL if recipe == "bf16" else grad_tol
        for got, want in outs:
            assert _rel(_np(got), np.asarray(want)) <= bar
        for k in ("conv", "state"):
            assert _rel(_np(tc[k]), np.asarray(jc[k])) <= bar, k


# ---------------------------------------------------------------------------
# The whole model
# ---------------------------------------------------------------------------

def _batch(vocab, b=2, s=64, seed=4):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    toks = toks.astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "targets": torch.from_numpy(toks[:, 1:].copy())})


def _models(name, seed=3, **over):
    jcfg, tcfg = _cfgs(name, **over)
    jmodel, tmodel = j_build(jcfg), t_build(tcfg, "cpu")
    jparams = jmodel.init(jax.random.PRNGKey(seed), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jmodel, tmodel, jparams, tparams


# (arch, recipe, the port's linear_impl, the reference's).  mamba2's
# pallas case is held to the reference's qdq route: on this batch the
# reference's own two routes part by one FP8 rounding flip in layer 0's
# in_b wgrad (4.3e-2 relative L2 between them), and the port's pallas and
# qdq routes give the same bits (checked here), equal to the reference's
# qdq route within the bar.  jamba under paper_fp4 is held by its loss
# (test_jamba_scan_layout_loss_matches_jax).
LOSS_CASES = [("mamba2_780m", "bf16", "qdq", "qdq"),
              ("mamba2_780m", "paper_fp4", "qdq", "qdq"),
              ("mamba2_780m", "paper_fp4", "pallas", "qdq"),
              ("jamba_1_5_large_398b", "bf16", "qdq", "qdq")]


def _port_loss_and_grads(tmodel, tparams, tb, recipe):
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tl, tmet = tmodel.loss(tparams, tb, T_RECIPES[recipe])
    return tl, tmet, torch.autograd.grad(tl, leaves)


@pytest.mark.parametrize("name,recipe,impl,j_impl", LOSS_CASES)
def test_loss_and_grads_match_jax(name, recipe, impl, j_impl):
    """``Model.loss`` and the gradient of every leaf, f32, against the
    reference: mamba2 ``REDUCED`` (2 mamba layers, tied embeddings) and
    jamba ``REDUCED`` (8 layers: attention at layer 4, MoE on the odd
    layers), unrolled on both sides."""
    loss_tol, grad_tol = GRAD_TOL[recipe]
    jcfg, tcfg, _, tmodel, jparams, tparams = _models(
        name, linear_impl=impl)
    jmodel = j_build(jcfg.replace(linear_impl=j_impl))
    jb, tb = _batch(tcfg.vocab_size, s=32 if jcfg.moe else 64)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, J_RECIPES[recipe]),
        has_aux=True))(jparams)
    tl, tmet, tg = _port_loss_and_grads(tmodel, tparams, tb, recipe)
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=loss_tol)
    np.testing.assert_allclose(float(tmet["total_loss"].detach()),
                               float(jmet["total_loss"]), rtol=loss_tol)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jg), tcfg))
    assert len(want) == len(tg)
    for i, (a, b) in enumerate(zip(tg, want)):
        assert np.isfinite(_np(a)).all()
        assert _rel(_np(a), b.numpy()) <= grad_tol, (i, tuple(a.shape))
    if impl != j_impl:
        _, _, other = _port_loss_and_grads(
            t_build(tcfg.replace(linear_impl=j_impl), "cpu"),
            params_from_jax(jax.tree.map(np.asarray, jparams), tcfg), tb,
            recipe)
        for a, b in zip(tg, other):
            assert torch.equal(a, b)


def test_jamba_scan_layout_loss_matches_jax():
    """jamba ``REDUCED`` scan-stacked (one period-8 group: l00..l07, the
    attention layer at l04) loads into the port, and its loss under
    paper_fp4 equals the reference's (f32).  The loss, not the gradients:
    across 8 layers of mixers, MoE and attention an FP8 wgrad rounding
    flip moves some gradient leaf by a few per cent of its max (3.1e-2
    measured on a w_down), past the bar that the mamba2 cases hold."""
    jcfg, tcfg = _cfgs("jamba_1_5_large_398b", scan_layers=True)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(2), jnp.float32)
    assert sorted(jparams["stack"]["groups"]) == [f"l{i:02d}"
                                                  for i in range(8)]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    assert "wq" in tparams["stack"]["groups"]["l04"]["mixer"]
    assert "in_x" in tparams["stack"]["groups"]["l03"]["mixer"]
    jb, tb = _batch(tcfg.vocab_size, s=32)
    jl, jmet = jax.jit(lambda p: jmodel.loss(
        p, jb, J_RECIPES["paper_fp4"]))(jparams)
    tl, tmet = t_build(tcfg, "cpu").loss(tparams, tb,
                                         T_RECIPES["paper_fp4"])
    for k in ("loss", "moe_load_balance", "total_loss"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   rtol=GRAD_TOL["paper_fp4"][0], err_msg=k)


def test_remat_is_bitwise_no_remat():
    """Per-layer remat re-runs the mixer: the same loss and gradients bit
    for bit as without it (mamba2 ``REDUCED``, paper_fp4, pallas)."""
    _, tcfg = _cfgs("mamba2_780m", linear_impl="pallas")
    out = []
    for remat in (True, False):
        model = t_build(tcfg.replace(remat=remat), "cpu")
        params = model.init(0)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tb = _batch(tcfg.vocab_size)[1]
        loss, _ = model.loss(params, tb, T_RECIPES["paper_fp4"])
        out.append((loss.detach(), torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_trainer_matches_jax():
    """mamba2 ``REDUCED``, f32, paper_fp4 with linear_impl "pallas" on
    the port's side, AdamW, 3 steps of 2 x 64 tokens against the JAX
    ``Trainer``: per-step loss, grad norm and LR, and the final
    parameters (``a_log``, ``dt_bias`` and ``d_skip`` among them)."""
    over = dict(dtype="float32", linear_impl="pallas", scan_layers=False)
    jcfg, tcfg = _cfgs("mamba2_780m", **over)
    kw = dict(recipe="paper_fp4", total_steps=3, global_batch=2, seq_len=64)
    jtr = JTrainer(j_build(jcfg), JTrainConfig(**kw),
                   JSynthetic(jcfg.vocab_size, 64, 2, seed=0))
    ttr = Trainer(t_build(tcfg, "cpu"), TrainConfig(**kw),
                  SyntheticLM(tcfg.vocab_size, 64, 2, seed=0))
    jstate = jtr.init_state()
    tstate = ttr.init_state(params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    jstate = jtr.train(jstate)
    tstate = ttr.train(tstate)
    for key, rtol in (("loss", TRAIN_TOL["loss"]),
                      ("grad_norm", TRAIN_TOL["grad_norm"]), ("lr", 1e-6)):
        np.testing.assert_allclose(
            [r[key] for r in ttr.history], [r[key] for r in jtr.history],
            rtol=rtol, err_msg=key)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg)
    for a, b in zip(tree_leaves(tstate.params), tree_leaves(ref)):
        np.testing.assert_allclose(_np(a), b.numpy(), rtol=0,
                                   atol=TRAIN_TOL["params"])


@pytest.mark.parametrize("name,scan", [("mamba2_780m", False),
                                       ("jamba_1_5_large_398b", True)])
def test_opt_state_from_jax(name, scan):
    """AdamW's moments come across over the mamba leaves (f32
    ``dt_bias`` / ``a_log`` / ``d_skip`` among them) and jamba's period-8
    scan groups, in the shapes of the port's own fresh state."""
    jcfg, tcfg = _cfgs(name, scan_layers=scan)
    jparams = j_build(jcfg).init(jax.random.PRNGKey(5), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    jst = j_adamw().init(jparams)
    jst = jst._replace(mu=jax.tree.map(lambda a: a + 0.25, jst.mu),
                       nu=jax.tree.map(lambda a: a + 0.5, jst.nu))
    got = opt_state_from_jax(jax.tree.map(np.asarray, jst), tcfg)
    fresh = adamw().init(tparams)
    for f, v in (("mu", 0.25), ("nu", 0.5)):
        g_leaves, f_leaves = (tree_leaves(getattr(t, f))
                              for t in (got, fresh))
        assert [tuple(x.shape) for x in g_leaves] == \
            [tuple(x.shape) for x in f_leaves], f
        assert all(bool((x == v).all()) for x in g_leaves), f
