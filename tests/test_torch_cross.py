"""The port's cross-attention families against the JAX reference, on the
CPU: llama-3.2-vision-90b (vlm: a cross sublayer on layer 3 of
``REDUCED``'s 5, over ``vision`` states) and whisper-base (audio: an
encoder over ``frames``), at ``REDUCED`` size.

Every test that can see the cross path sets every ``cross_gate`` to 1.0
on both sides: the init's gate is 0 (``tanh(0) = 0``), and a test at the
init's gate would pass whatever the cross path computed.  The JAX side
runs unrolled (``scan_layers=False``) and its Pallas kernels in
interpret mode; the port runs the CUDA kernels' plain versions on CPU
tensors.  Bars:

* bitwise: configs, layer specs and scan periods; ``sincos_positions``;
  the cost model's dims and parameter counts;
* allclose: the cross sublayer with states and over a cache (TOL, f32);
  ``_encode`` (TOL, under bf16 and paper_fp4);
  ``Model.loss`` and every gradient (GRAD_TOL, as
  ``tests/test_torch_moe.py``).

Training (the ``Trainer``, the census, telemetry) is in
``tests/test_torch_cross_train.py``, serving in
``tests/test_torch_cross_serving.py``.

Two reference properties are shown in both packages: whisper's decoder
has no cross sublayer (its loss does not depend on ``frames`` and every
encoder gradient is 0), and at the init's zero gate the vlm loss does not
depend on ``vision``.
"""
import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.cost_model import ModelDims as JDims  # noqa: E402
from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.nn.layers import sincos_positions as j_sincos  # noqa: E402
from repro.optim.adafactor import adafactor as j_adafactor  # noqa: E402
from repro.optim.adamw import adamw as j_adamw  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import ModelDims as TDims  # noqa: E402
from repro_torch.core.recipe import RECIPES as T_RECIPES  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.nn.layers import sincos_positions  # noqa: E402
from repro_torch.optim import adafactor, adamw  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

VLM, AUDIO = "llama_3_2_vision_90b", "whisper_base"
# max |diff| / max |ref| of a sublayer's output (f32: summation order)
TOL = 1e-6
# loss rtol, and a gradient leaf's max |diff| / max |ref| (as
# tests/test_torch_moe.py)
GRAD_TOL = {"bf16": (1e-5, 1e-4), "paper_fp4": (1e-5, 2e-2)}
SEQ, BATCH = 32, 2


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


def _rel(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def open_gates(tree, value=1.0):
    """``tree`` (the reference's, nested dicts and lists) with every
    ``cross_gate`` set to ``value``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.full_like(x, value)
                         if getattr(path[-1], "key", None) == "cross_gate"
                         else x), tree)


def _models(name, gate=1.0, **over):
    jcfg, tcfg = _cfgs(name, **over)
    jmodel, tmodel = j_build(jcfg), t_build(tcfg, "cpu")
    jparams = jmodel.init(jax.random.PRNGKey(3), jnp.float32)
    if gate is not None:
        jparams = open_gates(jparams, gate)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jmodel, tmodel, jparams, tparams


def _states(cfg, b=BATCH, seed=5):
    """(key, (b, n, d) f32 states): ``vision`` patches or ``frames``."""
    key, n = (("vision", cfg.n_patches) if cfg.family == "vlm"
              else ("frames", cfg.n_frames))
    rng = np.random.default_rng(seed)
    return key, rng.standard_normal((b, n, cfg.d_model)).astype(np.float32)


def _batch(cfg, seed=4, states_seed=5):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    key, st = _states(cfg, seed=states_seed)
    raw = {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy(),
           key: st}
    return ({k: jnp.asarray(v) for k, v in raw.items()},
            {k: torch.from_numpy(v) for k, v in raw.items()})


def _loss_and_grads(tmodel, tparams, tb, recipe):
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    try:
        tl, tmet = tmodel.loss(tparams, tb, T_RECIPES[recipe])
        tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return tl.detach(), tmet, tg


# ---------------------------------------------------------------------------
# Configs, positions, cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_config_and_layer_specs_match_jax(name):
    """Field for field, with the reference's cross placement: vlm
    ``REDUCED`` has its cross sublayer on layer 3 (period 5, scan period
    5); whisper (period 1) has none, at either size."""
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
    crosses = [i for i, s in enumerate(tm.REDUCED.layer_specs()) if s.cross]
    assert crosses == ([3] if name == VLM else [])
    if name == VLM:
        assert tm.REDUCED.scan_period() == 5
        assert sum(s.cross for s in tm.CONFIG.layer_specs()) == 20
    else:
        assert not any(s.cross for s in tm.CONFIG.layer_specs())


@pytest.mark.parametrize("shape", [(16, 64), (1500, 512), (7, 6)])
def test_sincos_positions_bitwise(shape):
    got = sincos_positions(*shape, "cpu").numpy()
    want = np.asarray(j_sincos(*shape))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_cost_model_cross_rows_and_param_counts(name):
    """``ModelDims`` (a cross sublayer adds a second attention row) and
    the parameter counts (the encoder's included) equal the reference's,
    at full and reduced size."""
    jm, tm = _modules(name)
    for what in ("CONFIG", "REDUCED"):
        jc, tc = getattr(jm, what), getattr(tm, what)
        assert dataclasses.astuple(TDims.from_config(tc, 448)) == \
            dataclasses.astuple(JDims.from_config(jc, 448))
        assert t_build(tc, "cpu").param_count() == j_build(jc).param_count()
    if name == VLM:
        rows = TDims.from_config(tm.REDUCED, 64).layers
        assert rows[3].attn_linear == 2 * rows[0].attn_linear


# ---------------------------------------------------------------------------
# The sublayer and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe", ["bf16", "paper_fp4"])
def test_cross_attention_matches_jax(recipe):
    """The cross sublayer, f32, over vision states (training: K/V
    projected from them) and over a cache (a prefill writes the K/V into
    it in place, a decode step reads them), against the reference's."""
    jcfg, tcfg, _, _, jparams, tparams = _models(VLM)
    jl = jparams["stack"]["layers"][3]["cross"]
    tl = tparams["stack"]["layers"][3]["cross"]
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    _, st = _states(jcfg, b=2)
    jr, tr = J_RECIPES[recipe].attn_linear, T_RECIPES[recipe].attn_linear
    jo, jc = j_attn.cross_attention(jl, jcfg, jnp.asarray(x), jr,
                                    kv_states=jnp.asarray(st))
    to = t_attn.cross_attention(tl, tcfg, torch.from_numpy(x), tr,
                                kv_states=torch.from_numpy(st))
    assert _rel(to.numpy(), np.asarray(jo)) <= TOL
    cache = {n: torch.zeros(tuple(jc[n].shape)) for n in ("k", "v")}
    tp = t_attn.cross_attention(tl, tcfg, torch.from_numpy(x), tr,
                                kv_states=torch.from_numpy(st), cache=cache)
    assert torch.equal(tp, to)
    for n in ("k", "v"):
        assert _rel(cache[n].numpy(), np.asarray(jc[n])) <= TOL
    jd, _ = j_attn.cross_attention(jl, jcfg, jnp.asarray(x1), jr, cache=jc)
    td = t_attn.cross_attention(tl, tcfg, torch.from_numpy(x1), tr,
                                cache=cache)
    assert _rel(td.numpy(), np.asarray(jd)) <= TOL


@pytest.mark.parametrize("recipe", ["bf16", "paper_fp4"])
def test_encode_matches_jax(recipe):
    """whisper's ``_encode`` (sinusoidal positions, the non-causal
    encoder stack under the resized plan, the final norm) on its own,
    f32, against the reference's ``Model._encode``."""
    _, tcfg, jmodel, tmodel, jparams, tparams = _models(
        AUDIO, gate=None, linear_impl="pallas")
    _, frames = _states(tcfg)
    got = tmodel._encode(tmodel.cast_params(tparams),
                         torch.from_numpy(frames),
                         tmodel._plan(T_RECIPES[recipe]))
    want = jmodel._encode(jmodel.cast_params(jparams), jnp.asarray(frames),
                          jmodel._plan(J_RECIPES[recipe]))
    assert got.shape == (BATCH, tcfg.n_frames, tcfg.d_model)
    assert _rel(_np(got), np.asarray(want)) <= TOL


# ---------------------------------------------------------------------------
# The model's loss and gradients; the reference properties
# ---------------------------------------------------------------------------

LOSS_CASES = [(VLM, "bf16", "qdq"), (VLM, "paper_fp4", "qdq"),
              (VLM, "paper_fp4", "pallas"), (AUDIO, "bf16", "qdq"),
              (AUDIO, "paper_fp4", "pallas")]


@pytest.mark.parametrize("name,recipe,impl", LOSS_CASES)
def test_loss_and_grads_match_jax(name, recipe, impl):
    """``Model.loss`` and the gradient of every leaf (the cross sublayer
    and its f32 gate; whisper's encoder) against the reference's, f32.
    whisper's encoder gradients are all zeros on both sides: the port
    leaves them unreached (None), the reference's are 0."""
    loss_tol, grad_tol = GRAD_TOL[recipe]
    _, tcfg, jmodel, tmodel, jparams, tparams = _models(
        name, linear_impl=impl)
    jb, tb = _batch(tcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, J_RECIPES[recipe]),
        has_aux=True))(jparams)
    tl, _, tg = _loss_and_grads(tmodel, tparams, tb, recipe)
    np.testing.assert_allclose(float(tl), float(jl), rtol=loss_tol)
    want = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    enc = ({id(p) for p in tree_leaves(tparams["encoder"])}
           if name == AUDIO else set())
    assert len(enc) == (22 if name == AUDIO else 0)
    for p, a, b in zip(tree_leaves(tparams), tg, tree_leaves(want)):
        if id(p) in enc:
            assert a is None and not bool(b.any())
        else:
            assert _rel(_np(a), b.numpy()) <= grad_tol, tuple(a.shape)
    if name == VLM:
        gate = tg[[id(p) for p in tree_leaves(tparams)].index(
            id(tparams["stack"]["layers"][3]["cross_gate"]))]
        assert gate.dtype == torch.float32 and float(gate.abs()) > 0


def test_whisper_loss_does_not_depend_on_frames():
    """Reference property 1 (``repro/configs/base.py:99-101``): with a
    cross period of 1 no decoder layer has a cross sublayer, so the loss
    is the same for two frame tensors, in both packages, and equal."""
    _, tcfg, jmodel, tmodel, jparams, tparams = _models(AUDIO, gate=None)
    losses = []
    for states_seed in (5, 6):
        jb, tb = _batch(tcfg, states_seed=states_seed)
        losses.append((float(jmodel.loss(jparams, jb,
                                         J_RECIPES["bf16"])[0]),
                       float(tmodel.loss(tparams, tb,
                                         T_RECIPES["bf16"])[0])))
    assert losses[0][0] == losses[1][0] and losses[0][1] == losses[1][1]
    np.testing.assert_allclose(losses[0][1], losses[0][0], rtol=1e-6)


def test_vlm_loss_at_the_init_gate_does_not_depend_on_vision():
    """Reference property 2 (``repro/models/stack.py:80-82``): every
    ``cross_gate`` starts at 0, so at the init the loss is the same for
    two vision tensors in both packages; with the gates at 1.0 it is
    not."""
    for gate, same in ((None, True), (1.0, False)):
        _, tcfg, jmodel, tmodel, jparams, tparams = _models(VLM, gate=gate)
        out = []
        for states_seed in (5, 6):
            jb, tb = _batch(tcfg, states_seed=states_seed)
            out.append((float(jmodel.loss(jparams, jb,
                                          J_RECIPES["bf16"])[0]),
                        float(tmodel.loss(tparams, tb,
                                          T_RECIPES["bf16"])[0])))
        for side in (0, 1):
            assert (out[0][side] == out[1][side]) == same, (gate, out)
        np.testing.assert_allclose(out[0][1], out[0][0], rtol=1e-5)


@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_scan_layout_loads_and_gives_the_unrolled_loss(name):
    """A scan-stacked tree (vlm: five groups of one, the cross leaves and
    the f32 gate under ``l03``; whisper: the encoder's own groups) comes
    across under the specs' key order and gives the unrolled tree's
    loss."""
    jcfg, tcfg = _cfgs(name, scan_layers=True)
    jmodel = j_build(jcfg)
    jparams = open_gates(jmodel.init(jax.random.PRNGKey(1), jnp.float32))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    groups = tparams["stack"]["groups"]
    if name == VLM:
        assert sorted(groups) == [f"l{i:02d}" for i in range(5)]
        assert list(groups["l03"]) == ["mixer_norm", "mixer", "cross_norm",
                                       "cross", "cross_gate", "ffn_norm",
                                       "ffn"]
        assert groups["l03"]["cross_gate"].shape == (1, 1)
        assert groups["l03"]["cross_gate"].dtype == torch.float32
    else:
        assert list(tparams["encoder"]) == ["stack", "final_norm"]
        assert "groups" in tparams["encoder"]["stack"]
    jb, tb = _batch(tcfg)
    jl = jmodel.loss(jparams, jb, J_RECIPES["bf16"])[0]
    tl = t_build(tcfg, "cpu").loss(tparams, tb, T_RECIPES["bf16"])[0]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("name", [VLM, AUDIO])
def test_opt_state_from_jax_cross(name, scan):
    """A cross family's optimizer state comes across in either layout
    (the cross leaves and the f32 gate; the encoder subtree): AdamW's
    moments and Adafactor's factors with the shapes of the port's own
    fresh state, in the specs' key order, and the reference's values."""
    jcfg, tcfg = _cfgs(name, scan_layers=scan)
    jparams = j_build(jcfg).init(jax.random.PRNGKey(5), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    for jopt, topt in ((j_adamw(), adamw()), (j_adafactor(), adafactor())):
        jst = jopt.init(jparams)
        jst = jst._replace(**{f: jax.tree.map(
            lambda a: a + 0.25, getattr(jst, f))
            for f in jst._fields if f != "count"})
        got = opt_state_from_jax(jax.tree.map(np.asarray, jst), tcfg)
        fresh = topt.init(tparams)
        for f in fresh._fields:
            if f == "count":
                continue
            g_leaves, f_leaves = (tree_leaves(getattr(t, f))
                                  for t in (got, fresh))
            assert [tuple(x.shape) for x in g_leaves] == \
                [tuple(x.shape) for x in f_leaves], f
            assert all(bool((x == 0.25).all()) for x in g_leaves), f
