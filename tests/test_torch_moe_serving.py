"""The port's MoE family on its serving path, and its route census and
telemetry, against the JAX reference on the CPU (``olmoe-1b-7b`` and
``mixtral-8x22b`` ``REDUCED``; the JAX side unrolled, its Pallas kernels
in interpret mode; the port the kernels' plain versions on CPU tensors).

* Packed expert panels: every (layer, expert) matrix packed on its own,
  payload and scales bitwise the reference's; the f32 router dense.
* Engine logits (packed fp4 weights, fp8 KV, paper_fp4, "pallas"): the
  prefill and 4 batched decode steps within ``tests/test_torch_decode``'s
  bar, the reference compiled without excess precision.  mixtral has a
  sliding window: exact-length prefill.
* The bucketing property: the reference's bucket-padded prefill routes
  the pad rows too, so with pads taking capacity it differs from the
  exact-length prefill; the port's does the same, matching each.
* Route census: one train step and one packed decode step give the
  reference's cells (the batched expert matmul records once a role).
* Telemetry: one instrumented step's rows (the batched taps' per-expert
  averages, the MoE probe rows) within ``test_torch_telemetry``'s step-0
  bars.
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import routing as j_routing  # noqa: E402
from repro.core.packed import PackedTensor as JPacked  # noqa: E402
from repro.core.recipe import PrecisionPlan as JPlan  # noqa: E402
from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train import train_step as j_step  # noqa: E402
from repro.train.serving_runtime import DecodeEngine as JEngine  # noqa: E402
from repro.train.serving_runtime import (  # noqa: E402
    quantize_weights_for_serving as j_quantize)
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import routing  # noqa: E402
from repro_torch.core.packed import PackedTensor  # noqa: E402
from repro_torch.core.recipe import PrecisionPlan  # noqa: E402
from repro_torch.core.recipe import RECIPES as T_RECIPES  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.train.serving_runtime import (  # noqa: E402
    DecodeEngine, quantize_weights_for_serving, serving_memory_report)
from repro_torch.train.train_step import make_optimizer  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

# tests/test_torch_decode.py's bar: max |logit diff| / max |logit|
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
MAX_LEN = 32
N_STEPS = 4


def _cfgs(arch, **over):
    over = {**dict(dtype="float32", linear_impl="pallas",
                   scan_layers=False), **over}
    j = importlib.import_module(f"repro.configs.{arch}").REDUCED
    t = importlib.import_module(f"repro_torch.configs.{arch}").REDUCED
    return j.replace(**over), t.replace(**over)


def _rel(a, b):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.to(torch.float32).numpy()
    return float(np.abs(a - b).max() / np.abs(a).max())


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(NO_EXCESS_PRECISION)


def _engines(arch, dtype="float32", **over):
    jcfg, tcfg = _cfgs(arch, dtype=dtype, **over)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    je = JEngine(jm, j_quantize(jm, jp, "fp4_e2m1"), n_slots=2,
                 max_len=MAX_LEN, recipe=J_RECIPES["paper_fp4"],
                 kv_format="fp8_e4m3")
    tm = t_build(tcfg, "cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    te = DecodeEngine(tm, quantize_weights_for_serving(tm, tp, "fp4_e2m1",
                                                       device="cpu"),
                      n_slots=2, max_len=MAX_LEN,
                      recipe=T_RECIPES["paper_fp4"], kv_format="fp8_e4m3",
                      device="cpu")
    return jcfg, jp, je, te


def _prefill_both(je, te, prompt, width):
    """Prefill logits of ``prompt`` right-padded to ``width`` in each
    engine's model: (reference, port, the reference's cache, the
    port's cache)."""
    n = len(prompt)
    padded = np.zeros((1, width), np.int32)
    padded[0, :n] = prompt
    jcache = je.model.init_cache(1, MAX_LEN, je.cache_dtype, per_slot=True)
    fn = _compiled(
        lambda p, t, c: je.model.prefill(p, {"tokens": t}, c, je.recipe,
                                         true_length=n),
        je.params, jnp.asarray(padded), jcache)
    jl, jc = fn(je.params, jnp.asarray(padded), jcache)
    tl, tc = te.model.prefill(
        te.params, torch.from_numpy(padded).long(),
        te.model.init_cache(1, MAX_LEN, te.cache_dtype, per_slot=True),
        te.recipe, true_length=n)
    return jl, tl, jc, tc


# ---------------------------------------------------------------------------
# Packed experts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", [False, True])
def test_packed_experts_bitwise(scan):
    """Every expert leaf packs matrix by matrix, (E, K, N) unrolled or
    (L, E, K, N) scan-stacked: payload and scales bitwise the
    reference's; the f32 router stays dense; the memory report counts
    the expert panels."""
    jcfg, tcfg = _cfgs("olmoe_1b_7b", scan_layers=scan)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(2))
    jq = j_quantize(jm, jp, "fp4_e2m1")
    tm = t_build(tcfg, "cpu")
    tq = quantize_weights_for_serving(
        tm, params_from_jax(jax.tree.map(np.asarray, jp), tcfg),
        "fp4_e2m1", device="cpu")
    if scan:
        jffn, tffn = (q["stack"]["groups"]["l00"]["ffn"] for q in (jq, tq))
    else:
        jffn, tffn = (q["stack"]["layers"][1]["ffn"] for q in (jq, tq))
    assert isinstance(tffn["router"], torch.Tensor)
    assert tffn["router"].dtype == torch.float32
    assert not isinstance(jffn["router"], JPacked)
    for name in ("w_up", "w_gate", "w_down"):
        j, t = jffn[name], tffn[name]
        assert isinstance(t, PackedTensor) and t.shape == tuple(j.shape)
        np.testing.assert_array_equal(t.payload.numpy(),
                                      np.asarray(j.payload))
        np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    report = serving_memory_report(tq)
    n_expert = 3 * tcfg.n_layers * tcfg.moe.num_experts * tcfg.d_model * \
        tcfg.d_ff
    assert report["packed_params"] >= n_expert
    assert 0.25 < report["vs_bf16"] < 0.3


# ---------------------------------------------------------------------------
# Engine logits, bucketing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,dtype", [("olmoe_1b_7b", "float32"),
                                        ("olmoe_1b_7b", "bfloat16"),
                                        ("mixtral_8x22b", "float32")])
def test_engine_logits_match_jax(arch, dtype):
    """Prefill (the engine's bucket, exact length under mixtral's
    window) and 4 batched decode steps of the packed-FP4 MoE engine,
    port vs reference under the same tokens."""
    jcfg, _, je, te = _engines(arch, dtype)
    n = 11
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, n)
    width = te.bucket(n)
    assert width == (16 if not jcfg.sliding_window else n)
    jl, tl, jc, tc = _prefill_both(je, te, prompt, width)
    assert _rel(jl, tl) <= TOL[dtype]
    tok = int(jnp.argmax(jl[0, -1].astype(jnp.float32)))
    je.insert(jc, tok, 0)
    te.insert(tc, tok, 0)
    j_decode = _compiled(
        lambda p, t, c: je.model.decode_step(p, t, c, je.recipe),
        je.params, jnp.asarray(je.last_tok[:, None]), je.cache)
    for _ in range(N_STEPS):
        toks = je.last_tok[:, None].copy()
        jl, je.cache = j_decode(je.params, jnp.asarray(toks), je.cache)
        tl, te.cache = te.model.decode_step(
            te.params, torch.from_numpy(toks).long(), te.cache, te.recipe)
        assert _rel(jl, tl) <= TOL[dtype]
        je.last_tok = np.asarray(jnp.argmax(
            jl[:, -1].astype(jnp.float32), axis=-1)).astype(np.int32)


def test_bucketed_prefill_differs_from_exact_length():
    """The reference buckets MoE prompts (its ``_can_bucket`` looks at
    the mixers and the window only) and routes the pad rows like tokens:
    an 11-token prompt padded to 16 has another router group size, hence
    another capacity, and the pads take slots, so its last logits differ
    from the exact-length prefill.  The port's prefills differ the same
    way and each matches the reference's."""
    jcfg, _, je, te = _engines("olmoe_1b_7b")
    prompt = np.random.default_rng(1).integers(0, jcfg.vocab_size, 11)
    out = {}
    for width in (11, 16):
        jl, tl, _, _ = _prefill_both(je, te, prompt, width)
        assert _rel(jl, tl) <= TOL["float32"]
        out[width] = (np.asarray(jl, np.float32), tl.numpy())
    for side in (0, 1):
        diff = np.abs(out[11][side] - out[16][side]).max()
        assert diff > 1e-3 * np.abs(out[11][side]).max()
    assert te.bucket(11) == 16 and je._can_bucket


# ---------------------------------------------------------------------------
# Route census
# ---------------------------------------------------------------------------

def _cells(log):
    return sorted(log.to_dict()["cells"], key=repr)


@pytest.mark.parametrize("arch", ["olmoe_1b_7b", "mixtral_8x22b"])
def test_train_step_census_matches_reference(arch):
    """One paper_fp4 training step with remat: the cells (the expert
    matmuls' one event a role, in the ``ffn`` class) equal the
    reference's."""
    jcfg, tcfg = _cfgs(arch)
    n = tcfg.n_layers
    jplan = JPlan.uniform(J_RECIPES["paper_fp4"], n)
    tplan = PrecisionPlan.from_dict(jplan.to_dict())
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (2, 65))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    j_tcfg = JTrainConfig(total_steps=8, global_batch=2, seq_len=64)
    jm = j_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.float32)
    opt_state = j_step.make_optimizer(jm, j_tcfg).init(params)
    fn = j_step.make_train_step(jm, j_tcfg, jplan, jit=False, donate=False)
    with j_routing.capture() as jlog:
        jax.make_jaxpr(fn)(params, opt_state, jnp.zeros((), jnp.float32),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.zeros((), jnp.int32),
                           jnp.ones((), jnp.float32))
    tm = t_build(tcfg, "cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    t_tcfg = TrainConfig(total_steps=8, global_batch=2, seq_len=64)
    step = make_train_step(tm, t_tcfg, tplan)
    with routing.capture() as tlog:
        step(tparams, make_optimizer(tm, t_tcfg).init(tparams), None,
             {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    got = _cells(tlog)
    assert got == _cells(jlog)
    ffn = {(c["layer"], c["role"]) for c in got if c["cls"] == "ffn"}
    assert ffn == {(f"L{i}", r) for i in range(n)
                   for r in ("fwd", "dgrad", "wgrad")}


@pytest.mark.parametrize("recipe", ["bf16", "paper_fp4"])
def test_decode_step_census_matches_reference(recipe):
    """One batched decode step of the packed MoE engine: under
    paper_fp4 the expanded expert panels go through the fused route
    under the recipe's ``fwd_w`` (the reference's expert path, not the
    dense ``packed_dot``); under bf16 the experts record nothing, as the
    reference's einsum does."""
    jcfg, tcfg = _cfgs("olmoe_1b_7b")
    jm = j_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    je = JEngine(jm, j_quantize(jm, jparams, "fp4_e2m1"), n_slots=2,
                 max_len=32, recipe=J_RECIPES[recipe])
    with j_routing.capture() as jlog:
        jax.make_jaxpr(je._generate_impl)(
            je.params, je.cache, jnp.zeros((2, 1), jnp.int32),
            jnp.zeros((2,), bool))
    tm = t_build(tcfg, "cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    te = DecodeEngine(tm, quantize_weights_for_serving(
        tm, tp, "fp4_e2m1", device="cpu"), n_slots=2, max_len=32,
        recipe=T_RECIPES[recipe], device="cpu")
    with routing.capture() as tlog:
        te.generate_step()
    got = _cells(tlog)
    assert got == _cells(jlog)
    ffn = [c for c in got if c["cls"] == "ffn"]
    if recipe == "bf16":
        assert ffn == []
    else:
        assert {(c["route"], c["spec_b"]) for c in ffn} == \
            {("pallas", "fp4_e2m1@tile128")}


# ---------------------------------------------------------------------------
# Telemetry
# ---------------------------------------------------------------------------

def test_trainer_telemetry_matches_jax():
    """One instrumented paper_fp4 step of olmoe ``REDUCED`` (f32, 2 x 64
    tokens, "pallas"): the same row keys as the reference's, the batched
    taps' per-expert averages and the other forward-side stats to rtol
    1e-5 (rates to 1e-6 absolute), backward-side rates within 5e-4 and
    tap counts exact (``test_torch_telemetry``'s step-0 bars)."""
    jcfg, tcfg = _cfgs("olmoe_1b_7b")
    kw = dict(recipe="paper_fp4", total_steps=1, global_batch=2,
              seq_len=64, telemetry=True)
    jtr = JTrainer(j_build(jcfg), JTrainConfig(**kw),
                   JSynthetic(jcfg.vocab_size, 64, 2, seed=0))
    ttr = Trainer(t_build(tcfg, "cpu"), TrainConfig(**kw),
                  SyntheticLM(tcfg.vocab_size, 64, 2, seed=0))
    jstate = jtr.init_state()
    tstate = ttr.init_state(params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    jtr.train(jstate)
    ttr.train(tstate)
    jr, tr = jtr.history[0], ttr.history[0]
    assert set(jr) == set(tr), set(jr) ^ set(tr)
    assert "tel/l01/moe/mm2/fwd_x/rel_err" in tr
    for key, ref in jr.items():
        if not key.startswith("tel/"):
            continue
        got, ref = float(tr[key]), float(ref)
        stat = key.rsplit("/", 1)[1]
        if stat == "taps":
            assert got == ref, key
        elif stat in ("clip", "underflow"):
            atol = 5e-4 if key.startswith("tel/bwd/") else 1e-6
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12,
                                       err_msg=key)
    np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=1e-6)
