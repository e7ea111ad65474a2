"""The port's MoE family against the JAX reference, on the CPU: configs,
routing, the batched expert matmul, the MoE sublayer, ``Model.loss`` and
its gradients, the in-place clip, the cost model and a short ``Trainer``
run, at ``olmoe-1b-7b`` and ``mixtral-8x22b`` ``REDUCED`` sizes.

The JAX side runs unrolled (``scan_layers=False``) and its Pallas kernels
in interpret mode; the port runs the CUDA kernels' plain versions on CPU
tensors.  Bars:

* bitwise: config fields; routing (each (token, k)'s expert, its slot,
  the kept mask, ``moe_frac_dropped``) on random tokens, on a padded last
  router group and on tokens whose probabilities tie exactly; the batched
  plain quantize pass (SR included) against the JAX vmap of the
  reference's; cost-model dims; the clip;
* allclose: ``moe`` outputs and aux losses under bf16 / paper_fp4 qdq /
  paper_fp4 pallas (TOL); ``Model.loss`` and every gradient (GRAD_TOL,
  f32 matmul order, or FP4 / FP8 rounding flips that a last-bit
  difference upstream of a quantizer causes); a 4-step ``Trainer`` run
  (TRAIN_TOL).  TF32 stays off.
"""
import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import MoESettings as JMoE  # noqa: E402
from repro.core.cost_model import ModelDims as JDims  # noqa: E402
from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.optim import clip_by_global_norm as j_clip  # noqa: E402
from repro.optim.adafactor import adafactor as j_adafactor  # noqa: E402
from repro.optim.adamw import adamw as j_adamw  # noqa: E402
from repro.train.trainer import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoESettings  # noqa: E402
from repro_torch.configs.base import TrainConfig, get_config  # noqa: E402
from repro_torch.convert import opt_state_from_jax  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.cost_model import ModelDims as TDims  # noqa: E402
from repro_torch.core.recipe import RECIPES as T_RECIPES  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.kernels import rounding as t_rounding  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.optim import adafactor, adamw  # noqa: E402
from repro_torch.optim import clip_by_global_norm  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

j_fm = importlib.import_module("repro.kernels.fp4_matmul")
t_fm = importlib.import_module("repro_torch.kernels.fp4_matmul")

ARCHS = ("olmoe_1b_7b", "mixtral_8x22b")
# max |diff| / max |ref| of a MoE sublayer's output and aux losses
TOL = {"bf16": 1e-6, "paper_fp4": 1e-6}
# loss rtol, and a gradient leaf's max |diff| / max |ref|: f32 summation
# order under bf16; under paper_fp4 an FP4 / FP8 rounding flip (a last-bit
# input difference moves an element a whole grid step) reaches a few per
# mille of a gradient leaf (5.8e-3 measured on mixtral's experts)
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


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_config_matches_jax(name):
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
    assert [f.name for f in dataclasses.fields(MoESettings)] == \
        [f.name for f in dataclasses.fields(JMoE)]


@pytest.mark.parametrize("every_k", [1, 2, 3])
def test_layer_specs_and_unported_families(every_k):
    """``every_k_layers`` places the MoE FFNs as the reference's specs
    do; dense configs keep dense specs; the vlm and audio families (no
    longer unported: their cross sublayers are
    tests/test_torch_cross.py's) give the reference's specs too, cross
    placement included, on the same MoE stack."""
    jm, tm = _modules("olmoe_1b_7b")
    moe = dict(num_experts=4, top_k=2, every_k_layers=every_k)
    jc = jm.REDUCED.replace(n_layers=6, moe=JMoE(**moe))
    tc = tm.REDUCED.replace(n_layers=6, moe=MoESettings(**moe))
    assert [dataclasses.astuple(s) for s in tc.layer_specs()] == \
        [dataclasses.astuple(s) for s in jc.layer_specs()]
    assert tc.scan_period() == jc.scan_period()
    dense = get_config("llama-1b")
    assert {s.ffn for s in dense.layer_specs()} == {"dense"}
    for family, period in (("vlm", every_k + 2), ("audio", 1)):
        jf = jc.replace(family=family, cross_attn_period=period)
        tf = tc.replace(family=family, cross_attn_period=period)
        assert [dataclasses.astuple(s) for s in tf.layer_specs()] == \
            [dataclasses.astuple(s) for s in jf.layer_specs()]
        assert tf.scan_period() == jf.scan_period()
        assert any(s.cross for s in tf.layer_specs()) == (family == "vlm")


@pytest.mark.parametrize("name", ARCHS + ("llama_3_2_vision_90b",
                                          "whisper_base"))
def test_cost_model_dims_and_param_counts(name):
    """``ModelDims.from_config`` (the MoE FFN scaled by top-k; a cross
    sublayer's second attention row) and the total / active parameter
    counts (an audio model's encoder included) equal the reference's
    exactly, at full and reduced size."""
    jm, tm = _modules(name)
    for what in ("CONFIG", "REDUCED"):
        jc, tc = getattr(jm, what), getattr(tm, what)
        assert dataclasses.astuple(TDims.from_config(tc, 2048)) == \
            dataclasses.astuple(JDims.from_config(jc, 2048))
        jmod, tmod = j_build(jc), t_build(tc, "cpu")
        assert tmod.param_count() == jmod.param_count()
        assert tmod.active_param_count() == jmod.active_param_count()


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def _jax_route(xg, router, st, gsz):
    """The reference's routing steps (``repro.models.moe.moe``), as it
    writes them: (expert_idx, slot, kept any-expert mask, gate_vals)."""
    logits = jnp.einsum("gtd,de->gte", xg.astype(jnp.float32), router)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, st.top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    e = st.num_experts
    capacity = max(int(np.ceil(gsz * st.top_k * st.capacity_factor / e)),
                   st.top_k)
    n_groups = xg.shape[0]
    onehot = jax.nn.one_hot(expert_idx, e, dtype=jnp.float32)
    flat = onehot.transpose(0, 2, 1, 3).reshape(n_groups, st.top_k * gsz, e)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = pos.reshape(n_groups, st.top_k, gsz, e).transpose(0, 2, 1, 3)
    within = pos < capacity
    kept = (onehot * within).sum(-1) > 0
    slot = jnp.einsum("gtke,gtke->gtk", pos, onehot).astype(jnp.int32)
    return expert_idx, slot, kept, gate_vals, capacity


ROUTE_CASES = {
    # random tokens, the REDUCED settings (group 64 over 2 x 64 tokens)
    "random": dict(tokens=(2, 64), moe={}, zero_from=None),
    # 128 tokens in groups of 48: a last group of 32 tokens and 16 pad
    # rows, which are routed (uniform probabilities) and take slots
    "padded": dict(tokens=(2, 64), moe=dict(group_size=48,
                                            capacity_factor=10.0),
                   zero_from=None),
    # exactly uniform probabilities (zero rows): ties broken toward the
    # lowest expert index, and capacity drops some
    "tied": dict(tokens=(2, 64), moe=dict(capacity_factor=1.0),
                 zero_from=40),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_routing_bitwise(case):
    c = ROUTE_CASES[case]
    jm, tm = _modules("olmoe_1b_7b")
    st_j = dataclasses.replace(jm.REDUCED.moe, **c["moe"])
    st_t = dataclasses.replace(tm.REDUCED.moe, **c["moe"])
    rng = np.random.default_rng(7)
    b, s = c["tokens"]
    d, e = jm.REDUCED.d_model, st_j.num_experts
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    if c["zero_from"] is not None:
        x[:, c["zero_from"]:] = 0.0
    router = (rng.standard_normal((d, e)) / np.sqrt(d)).astype(np.float32)
    tokens = b * s
    gsz = min(st_j.group_size, tokens)
    n_groups = -(-tokens // gsz)
    xt = np.concatenate([x.reshape(tokens, d),
                         np.zeros((n_groups * gsz - tokens, d), np.float32)])
    xg = xt.reshape(n_groups, gsz, d)
    idx_j, slot_j, kept_j, gate_j, cap = _jax_route(
        jnp.asarray(xg), jnp.asarray(router), st_j, gsz)
    logits = torch.matmul(torch.from_numpy(xg), torch.from_numpy(router))
    _, gate_t, idx_t, slot_t, kept_t = t_moe.route(logits, st_t.top_k, cap)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(slot_t.numpy(), np.asarray(slot_j))
    np.testing.assert_array_equal(kept_t.numpy(), np.asarray(kept_j))
    np.testing.assert_allclose(gate_t.numpy(), np.asarray(gate_j),
                               rtol=1e-6)
    if case == "tied":
        tied = idx_t.reshape(-1, st_t.top_k)[c["zero_from"]]
        assert tied.tolist() == list(range(st_t.top_k))
        assert not kept_t.all()
    if case == "padded":
        # pad rows took slots, and nothing was dropped
        assert n_groups * gsz > tokens and bool(kept_t.all())
    # the reference's own sublayer: the same fraction dropped, bitwise
    jcfg = jm.REDUCED.replace(dtype="float32", moe=st_j)
    tcfg = tm.REDUCED.replace(dtype="float32", moe=st_t)
    jp = {"router": jnp.asarray(router)}
    wk = dict(w_up=(e, d, jcfg.d_ff), w_gate=(e, d, jcfg.d_ff),
              w_down=(e, jcfg.d_ff, d))
    for k_, shape in wk.items():
        jp[k_] = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                             * 0.1)
    tp = {k_: torch.from_numpy(np.array(v)) for k_, v in jp.items()}
    jr, tr = J_RECIPES["bf16"].ffn_linear, T_RECIPES["bf16"].ffn_linear
    _, jaux = j_moe.moe(jp, jcfg, jnp.asarray(x), jr)
    _, taux = t_moe.moe(tp, tcfg, torch.from_numpy(x), tr)
    assert float(taux["moe_frac_dropped"]) == \
        float(jaux["moe_frac_dropped"])


def test_padded_tokens_take_capacity():
    """The reference routes a padded group's zero rows like tokens: with
    a tight capacity the pads displace real tokens, so the same tokens
    give another output when the group is padded (a prompt's bucket
    padding moves the routing of the real tokens).  The port does the
    same, and agrees with the reference on both."""
    jm, tm = _modules("olmoe_1b_7b")
    moe = dict(num_experts=8, top_k=2, group_size=64, capacity_factor=1.0)
    jcfg = jm.REDUCED.replace(dtype="float32", moe=JMoE(**moe))
    tcfg = tm.REDUCED.replace(dtype="float32", moe=MoESettings(**moe))
    rng = np.random.default_rng(3)
    d, f, e = jcfg.d_model, jcfg.d_ff, 8
    jp = {"router": jnp.asarray((rng.standard_normal((d, e)) * 0.5)
                                .astype(np.float32))}
    for k_, shape in dict(w_up=(e, d, f), w_gate=(e, d, f),
                          w_down=(e, f, d)).items():
        jp[k_] = jnp.asarray(rng.standard_normal(shape).astype(np.float32)
                             * 0.1)
    tp = {k_: torch.from_numpy(np.array(v)) for k_, v in jp.items()}
    x = rng.standard_normal((1, 40, d)).astype(np.float32)
    xpad = np.concatenate([x, np.zeros((1, 24, d), np.float32)], axis=1)
    outs = {}
    for what, arr in (("exact", x), ("padded", xpad)):
        jo, _ = j_moe.moe(jp, jcfg, jnp.asarray(arr),
                          J_RECIPES["bf16"].ffn_linear)
        to, _ = t_moe.moe(tp, tcfg, torch.from_numpy(arr),
                          T_RECIPES["bf16"].ffn_linear)
        assert _rel(to.numpy(), np.asarray(jo)) <= 1e-6
        outs[what] = (np.asarray(jo)[:, :40], to.numpy()[:, :40])
    assert np.abs(outs["exact"][0] - outs["padded"][0]).max() > 1e-3
    assert np.abs(outs["exact"][1] - outs["padded"][1]).max() > 1e-3


# ---------------------------------------------------------------------------
# The batched expert matmul's kernels (plain versions) vs the JAX vmap
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("mode,fmt,sr", [("block", "fp4_e2m1", True),
                                         ("tile", "fp4_e2m1", False),
                                         ("token", "fp8_e5m2", True),
                                         ("tensor", "fp8_e4m3", True)])
def test_batched_quantize_pass_matches_jax_vmap(mode, fmt, sr, trans):
    """The port's batched quantize pass against ``jax.vmap`` of the
    reference's (interpret mode), bitwise: one amax per expert for
    tensor mode, and with SR the same noise for every expert (the
    vmapped kernel's program ids are the unbatched grid's)."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((3, 128, 256)) * 2).astype(np.float32)
    x[1] *= 16
    seed = t_rounding.fold_seed((0, 0), 4, 1)
    kw = dict(mode=mode, fmt_name=fmt, trans=trans)
    jseed = jnp.asarray([seed], jnp.int32) if sr else None
    ref = jax.vmap(lambda t: j_fm.quantize_panels(
        t, sr=sr, seed=jseed, **kw))(jnp.asarray(x))
    got = t_fm.quantize_panels(torch.from_numpy(x), sr=sr,
                               seed=seed if sr else None, **kw)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(ref).view(np.int32))
    if sr:   # every expert drew the same noise: equal inputs, equal bits
        same = torch.from_numpy(np.repeat(x[:1], 3, axis=0))
        q = t_fm.quantize_panels(same, sr=True, seed=seed, **kw)
        assert torch.equal(q[0], q[2])


@pytest.mark.parametrize("pipeline", ["stream", "two_pass"])
def test_batched_fused_qmm_matches_jax_vmap(pipeline):
    """The expert forward (fp4 block x fp4 tile) and wgrad (fp8 block
    pair, x read transposed, SR on the gradient) as batched calls,
    against ``jax.vmap`` of the reference's ``fused_qmm``."""
    rng = np.random.default_rng(12)
    a = rng.standard_normal((2, 128, 256)).astype(np.float32)
    b = (rng.standard_normal((2, 256, 128)) * 0.05).astype(np.float32)
    seed = t_rounding.fold_seed((0, 0), 4, 1)
    for kw, sr in ((dict(a_mode="block", b_mode="tile", a_fmt="fp4_e2m1",
                         b_fmt="fp4_e2m1"), False),
                   (dict(a_mode="block", b_mode="block", a_fmt="fp8_e4m3",
                         b_fmt="fp8_e5m2", trans_a=True), True)):
        at = a.transpose(0, 2, 1).copy() if kw.get("trans_a") else a
        extra = dict(b_sr=True) if sr else {}
        ref = jax.vmap(lambda x, y: j_fm.fused_qmm(
            x, y, pipeline=pipeline, interpret=True,
            seed_b=jnp.asarray([seed], jnp.int32) if sr else None,
            **extra, **kw))(jnp.asarray(at), jnp.asarray(b))
        got = t_fm.fused_qmm(torch.from_numpy(at), torch.from_numpy(b),
                             pipeline=pipeline,
                             seed_b=seed if sr else None, **extra, **kw)
        assert got.shape == (2, 128, 128)
        assert _rel(got.numpy(), np.asarray(ref)) <= 1e-6


# ---------------------------------------------------------------------------
# The sublayer, the model's loss and gradients
# ---------------------------------------------------------------------------

def _batch(vocab, b=2, s=64, seed=4):
    toks = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    toks = toks.astype(np.int32)
    return ({"tokens": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])},
            {"tokens": torch.from_numpy(toks[:, :-1].copy()),
             "targets": torch.from_numpy(toks[:, 1:].copy())})


def _models(name, **over):
    jcfg, tcfg = _cfgs(name, **over)
    jmodel, tmodel = j_build(jcfg), t_build(tcfg, "cpu")
    jparams = jmodel.init(jax.random.PRNGKey(3), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jmodel, tmodel, jparams, tparams


@pytest.mark.parametrize("recipe,impl", [("bf16", "qdq"),
                                         ("paper_fp4", "qdq")])
@pytest.mark.parametrize("name", ARCHS)
def test_moe_sublayer_matches_jax(name, recipe, impl):
    """One MoE sublayer, bf16 activations, against the reference compiled
    op by op: the output and the three aux losses."""
    jcfg, tcfg, _, _, jparams, tparams = _models(
        name, dtype="bfloat16", linear_impl=impl)
    jl = jparams["stack"]["layers"][0]["ffn"]
    tl = {k: (v if k == "router" else v.to(torch.bfloat16))
          for k, v in tparams["stack"]["layers"][0]["ffn"].items()}
    jl = {k: (v if k == "router" else v.astype(jnp.bfloat16))
          for k, v in jl.items()}
    x = np.random.default_rng(5).standard_normal(
        (2, 64, jcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    fn = jax.jit(lambda p, v: j_moe.moe(
        p, jcfg, v, J_RECIPES[recipe].ffn_linear)).lower(jl, xj).compile(
            {"xla_allow_excess_precision": False})
    jo, jaux = fn(jl, xj)
    to, taux = t_moe.moe(tl, tcfg, torch.from_numpy(x).to(torch.bfloat16),
                         T_RECIPES[recipe].ffn_linear)
    assert _rel(_np(to), np.asarray(jo.astype(jnp.float32))) <= 1e-2
    for k in ("moe_load_balance", "moe_router_z", "moe_frac_dropped"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=TOL[recipe], err_msg=k)


LOSS_CASES = [("olmoe_1b_7b", "bf16", "qdq"),
              ("mixtral_8x22b", "bf16", "qdq"),
              ("olmoe_1b_7b", "paper_fp4", "qdq"),
              ("mixtral_8x22b", "paper_fp4", "qdq"),
              ("olmoe_1b_7b", "paper_fp4", "pallas")]


@pytest.mark.parametrize("name,recipe,impl", LOSS_CASES)
def test_loss_and_grads_match_jax(name, recipe, impl):
    """``Model.loss`` (cross-entropy + load-balance + router z) and the
    gradient of every leaf (router and experts included), f32, against
    the reference; the reported MoE metrics too."""
    loss_tol, grad_tol = GRAD_TOL[recipe]
    _, tcfg, jmodel, tmodel, jparams, tparams = _models(
        name, linear_impl=impl)
    jb, tb = _batch(tcfg.vocab_size)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, J_RECIPES[recipe]),
        has_aux=True))(jparams)
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tl, tmet = tmodel.loss(tparams, tb, T_RECIPES[recipe])
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=loss_tol)
    for k in ("moe_load_balance", "moe_router_z", "moe_frac_dropped",
              "total_loss"):
        np.testing.assert_allclose(float(tmet[k].detach()), float(jmet[k]),
                                   rtol=loss_tol, err_msg=k)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jg), tcfg))
    assert len(want) == len(tg)
    for i, (a, b) in enumerate(zip(tg, want)):
        assert _rel(_np(a), b.numpy()) <= grad_tol, (i, tuple(a.shape))


def test_scan_layout_and_period():
    """A scan-stacked MoE tree (period 2: dense and MoE layers
    alternating) loads into the port and gives the loss of the unrolled
    tree."""
    jm, tm = _modules("olmoe_1b_7b")
    moe = dict(num_experts=4, top_k=2, group_size=64, every_k_layers=2)
    over = dict(dtype="float32", n_layers=4)
    jcfg = jm.REDUCED.replace(moe=JMoE(**moe), **over)
    tcfg = tm.REDUCED.replace(moe=MoESettings(**moe), **over)
    jmodel = j_build(jcfg)                 # scan_layers=True
    jparams = jmodel.init(jax.random.PRNGKey(1), jnp.float32)
    assert sorted(jparams["stack"]["groups"]) == ["l00", "l01"]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    jb, tb = _batch(tcfg.vocab_size)
    jl = jmodel.loss(jparams, jb, J_RECIPES["bf16"])[0]
    tl = t_build(tcfg, "cpu").loss(tparams, tb, T_RECIPES["bf16"])[0]
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


def test_remat_is_bitwise_no_remat():
    """Remat replays the router: the same top-k, the same loss and
    gradients bit for bit as without remat."""
    _, tcfg = _cfgs("olmoe_1b_7b", linear_impl="pallas")
    out = []
    for remat in (True, False):
        model = t_build(tcfg.replace(remat=remat), "cpu")
        params = model.init(0)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        tb = _batch(tcfg.vocab_size)[1]
        loss, met = model.loss(params, tb, T_RECIPES["paper_fp4"])
        out.append((loss.detach(), met["moe_frac_dropped"].detach(),
                    torch.autograd.grad(loss, leaves)))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Clip, optimizer and the Trainer
# ---------------------------------------------------------------------------

def test_inplace_clip_matches_jax_bitwise():
    """The in-place clip on a MoE gradient tree (3-D expert leaves, the
    f32 router) equals the reference's ``clip_by_global_norm`` bit for
    bit, and scales the leaves it was given.  The gradients are small
    integers, so every partial sum of squares is exact and the norm is
    the same whatever order either side sums in (XLA's and PyTorch's
    f32 reductions differ in order, hence in last bits, on random
    values); the clip's scaling is then held bitwise."""
    _, tcfg, _, tmodel, jparams, _ = _models("olmoe_1b_7b")
    rng = np.random.default_rng(9)
    jg = jax.tree.map(lambda p: jnp.asarray(
        rng.integers(-3, 4, p.shape).astype(np.float32)), jparams)
    tg = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    leaves = tree_leaves(tg)
    got, norm = clip_by_global_norm(tg, 1.0)
    want, jnorm = j_clip(jg, 1.0)
    assert float(norm) == float(jnorm)
    assert got is tg
    for a, b in zip(leaves, tree_leaves(
            params_from_jax(jax.tree.map(np.asarray, want), tcfg))):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      b.numpy().view(np.int32))


def test_trainer_matches_jax():
    """olmoe ``REDUCED``, f32, paper_fp4 with both impls "pallas" on the
    port's side (the reference's qdq route would differ only by its SR
    generator, and paper_fp4 has no SR), adafactor, 4 steps of 2 x 64
    tokens against the JAX ``Trainer``: per-step loss, grad norm, LR and
    MoE metrics, and the final parameters."""
    over = dict(dtype="float32", linear_impl="pallas", scan_layers=False,
                optimizer="adafactor")
    jcfg, tcfg = _cfgs("olmoe_1b_7b", **over)
    kw = dict(recipe="paper_fp4", total_steps=4, global_batch=2, seq_len=64)
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
                      ("grad_norm", TRAIN_TOL["grad_norm"]), ("lr", 1e-6),
                      ("moe_load_balance", TRAIN_TOL["loss"]),
                      ("moe_router_z", TRAIN_TOL["loss"]),
                      ("moe_frac_dropped", 0)):
        np.testing.assert_allclose(
            [r[key] for r in ttr.history], [r[key] for r in jtr.history],
            rtol=rtol, err_msg=key)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg)
    for a, b in zip(tree_leaves(tstate.params), tree_leaves(ref)):
        np.testing.assert_allclose(_np(a), b.numpy(), rtol=0,
                                   atol=TRAIN_TOL["params"])


@pytest.mark.parametrize("scan", [False, True])
def test_opt_state_from_jax_moe(scan):
    """A MoE tree's optimizer state comes across in either layout (3-D
    expert leaves, or 4-D scan-stacked ones; the f32 router): AdamW's
    moments and Adafactor's factors with the shapes of the port's own
    fresh state and the reference's values."""
    jcfg, tcfg = _cfgs("olmoe_1b_7b", scan_layers=scan)
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


def test_moe_config_dataclass_roundtrip():
    """A MoE ``ModelConfig`` built field by field from the reference's
    equals the port's module config (the ``moe`` field a
    ``MoESettings``)."""
    jm, tm = _modules("olmoe_1b_7b")
    d = dataclasses.asdict(jm.CONFIG)
    d["moe"] = MoESettings(**d["moe"])
    assert ModelConfig(**d) == tm.CONFIG
