"""The port's stochastic rounding, stats epilogue, standalone quantizer
and quantization telemetry against the JAX reference, on the CPU.

JAX runs its Pallas kernels in interpret mode (their CPU default), where
stochastic rounding draws the counter-hash noise the port's kernels draw;
the port runs on the CPU, where every kernel wrapper takes its plain
version.  Inputs come from numpy.  Bars, each stated at its test:

* ``hash_bits`` / ``fold_seed``, SR quantize panels, ``quantize_blockwise``
  and ``finalize_quant_stats``: bitwise, but for its ``scale_spread``
  (a log2, within one f32 ulp: XLA's log2 is not correctly rounded).
* SR products: the GEMM bar of ``test_torch_kernels`` (only the f32
  summation order of the product differs).
* Stats vectors: lanes 0-2 and 5-7 (counts, scale extrema) bitwise; lanes
  3-4 (err², val²) within rtol 1e-6 in f32 and 1e-5 in bf16: the
  reference's bf16 sums are themselves ~1e-6 off an f64 sum at these
  sizes (val² of a 256 x 384 operand read 1.3e-6, the port's 3e-8).
  bf16 references are compiled with ``xla_allow_excess_precision`` off,
  which otherwise keeps the quantized values in f32 for err².
* The QDQ path's SR: distributional (its mean), as in
  ``tests/test_rounding.py``: the reference draws from ``jax.random``.
* The telemetry trainer: the same metric keys every step; losses to
  ``LOSS_RTOL`` (``test_torch_train``'s paper_fp4 bar); stats at the bars
  of ``test_trainer_telemetry_matches_jax``.
"""
import contextlib
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core.quantize import QuantSpec as JSpec  # noqa: E402
from repro.core.quantize import underflow_rate as j_underflow  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.kernels import rounding as j_rounding  # noqa: E402
from repro.kernels.ops import pallas_qmm as j_pallas_qmm  # noqa: E402
from repro.kernels.ops import quantize_blockwise as j_qblock  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.telemetry import collect as j_collect  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import recipe as t_recipe  # noqa: E402
from repro_torch.core.qlinear import qlinear  # noqa: E402
from repro_torch.core.quantize import QuantSpec as TSpec  # noqa: E402
from repro_torch.core.quantize import qdq as t_qdq  # noqa: E402
from repro_torch.core.quantize import underflow_rate  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import fp4_matmul as t_fm  # noqa: E402
from repro_torch.kernels import rounding as t_rounding  # noqa: E402
from repro_torch.kernels.ops import pallas_qmm as t_pallas_qmm  # noqa: E402
from repro_torch.kernels.ops import quantize_blockwise  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.telemetry import collect  # noqa: E402
from repro_torch.telemetry.writer import read_jsonl  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

j_fm = importlib.import_module("repro.kernels.fp4_matmul")

T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
KEY = np.array([3, 0x9E3779B9], np.uint32)
# Per-step loss bar of the trainer comparison, as test_torch_train's
# paper_fp4 bar: FP4 / FP8 rounding flips carried on by the optimizer.
LOSS_RTOL = 1e-2


def _both(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(np.asarray(x, np.float32)).to(T_DT[dtype]))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_bitwise(j, t):
    a, b = _np(j), _np(t)
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes(), int((a != b).sum())


def _assert_stats(j, t, dtype):
    ref, got = _np(j).reshape(8), _np(t)
    lanes = [0, 1, 2, 5, 6, 7]
    np.testing.assert_array_equal(got[lanes], ref[lanes])
    np.testing.assert_allclose(got[3:5], ref[3:5],
                               rtol=1e-6 if dtype == "float32" else 1e-5)


def _operand(shape, seed, scale=2.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    x[:, 3] = 0                       # a zero column: underflow-free zeros
    x[0, :5] = 1e-4 * scale           # tiny values: FP4 underflow
    return x


# ---------------------------------------------------------------------------
# The counter hash and the seeds
# ---------------------------------------------------------------------------

def test_hash_bits_and_fold_seed_bitwise():
    """uint32 hash bits, their uniforms and the folded seeds, bitwise,
    over negative and large seeds and offsets whose uint32 products wrap."""
    for seed in (0, 123, -1253433917, 2 ** 31 - 1):
        for r0, c0 in ((0, 0), (128, 64), (2 ** 31 - 3, 3)):
            jb = j_rounding.hash_bits((5, 7), jnp.int32(seed), r0, c0)
            tb = t_rounding.hash_bits((5, 7), seed, r0, c0)
            np.testing.assert_array_equal(np.asarray(jb).astype(np.int64),
                                          tb.numpy())
            np.testing.assert_array_equal(
                np.asarray(j_rounding.uniform_from_bits(jb)),
                t_rounding.uniform_from_bits(tb).numpy())
    for key in ((0, 0), (3, 0x9E3779B9), (0xFFFFFFFF, 7)):
        for salt in (0, 2, 4, 5):
            for which in (0, 1):
                ref = j_rounding.fold_seed(jnp.asarray(key, jnp.uint32),
                                           salt, which)
                assert int(ref[0]) == t_rounding.fold_seed(key, salt, which)


# ---------------------------------------------------------------------------
# In-kernel stochastic rounding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("mode,fmt", [("block", "fp4_e2m1"),
                                      ("tile", "fp4_e2m1"),
                                      ("token", "fp8_e5m2"),
                                      ("tensor", "fp8_e4m3")])
def test_sr_quantize_panels_bitwise(mode, fmt, trans, dtype):
    """The quantize pass with SR: the same noise on both sides, so the
    panels are bitwise equal, every mode, both read orientations."""
    x = _operand((128, 256), 20)
    xj, xt = _both(x, dtype)
    seed = t_rounding.fold_seed(KEY, 4, 1)
    ref = j_fm.quantize_panels(xj, mode=mode, fmt_name=fmt, sr=True,
                               seed=jnp.asarray([seed], jnp.int32),
                               trans=trans)
    got = t_fm.quantize_panels(xt, mode=mode, fmt_name=fmt, sr=True,
                               seed=seed, trans=trans)
    _assert_bitwise(ref, got)
    # and it is stochastic: RTN differs
    assert not torch.equal(got, t_fm.quantize_panels(
        xt, mode=mode, fmt_name=fmt, trans=trans))


# (trans_a, trans_b, mode_a, fmt_a, mode_b, fmt_b): the FFN wgrad of
# fine_grained_fp4 (SR B, x read transposed) first, then the other modes.
SR_CASES = [
    (True, False, "block", "fp4_e2m1", "block", "fp4_e2m1"),
    (False, False, "block", "fp4_e2m1", "tile", "fp4_e2m1"),
    (False, True, "tile", "fp8_e4m3", "block", "fp4_e2m1"),
    (True, True, "token", "fp8_e5m2", "tensor", "fp8_e4m3"),
    (False, True, "pass", "bf16", "token", "fp4_e2m1"),
]
RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SR_CASES,
                         ids=lambda c: f"ta{int(c[0])}tb{int(c[1])}-{c[2]}"
                         f"-{c[4]}")
def test_pallas_qmm_sr_matches_jax(case, dtype):
    """``pallas_qmm`` with stochastic specs on both operands (key, salt
    4): the quantized panels are bitwise equal (test above), so the
    products agree to the GEMM bar; 200 x 256 x 130, M and N ragged."""
    trans_a, trans_b, ma, fa, mb, fb = case
    m, k, n = 200, 256, 130
    a = _operand((k, m) if trans_a else (m, k), 21)
    b = _operand((n, k) if trans_b else (k, n), 22, 0.05)
    (aj, at), (bj, bt) = _both(a, dtype), _both(b, dtype)
    specs = [(S(fa, ma, stochastic=True) if ma != "pass" else S("bf16"),
              S(fb, mb, stochastic=True) if mb != "pass" else S("bf16"))
             for S in (JSpec, TSpec)]
    kw = dict(mode_a=ma, mode_b=mb, trans_a=trans_a, trans_b=trans_b,
              salt=4)
    ref = _np(j_pallas_qmm(aj, bj, *specs[0], key_data=jnp.asarray(KEY),
                           **kw))
    got = _np(t_pallas_qmm(at, bt, *specs[1], key_data=KEY, **kw))
    top = np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= RTOL[dtype] * np.abs(ref)
                  + 1e-5 * top), float(np.abs(got - ref).max())
    rtn = _np(t_pallas_qmm(at, bt, *(TSpec.from_str(s.to_str().replace(
        ":sr", "")) for s in specs[1]), **{**kw, "salt": 0}))
    assert not np.array_equal(got, rtn)


def test_qdq_path_sr_is_unbiased():
    """The QDQ path's SR (a torch.Generator) is held in distribution, as
    ``tests/test_rounding.py`` holds the reference's: the mean over 4000
    draws lands on the input and on the reference's jax.random mean."""
    from repro.core.formats import FORMATS as J_FORMATS
    from repro.core.formats import round_to_format as j_round
    from repro_torch.core.formats import FORMATS, round_to_format
    x = np.linspace(0.01, 5.9, 97, dtype=np.float32)
    xt = torch.from_numpy(x).expand(4000, 97)
    g = torch.Generator().manual_seed(123)
    mean = round_to_format(xt, FORMATS["fp4_e2m1"],
                           generator=g).mean(0).numpy()
    keys = jax.random.split(jax.random.PRNGKey(7), 8)
    xj = jnp.broadcast_to(jnp.asarray(x), (500, 97))
    mean_ref = np.mean([np.asarray(j_round(xj, J_FORMATS["fp4_e2m1"],
                                           stochastic_key=k)).mean(0)
                        for k in keys], axis=0)
    # top-binade step is 2 -> se <= 0.016 per column; 5 sigma
    assert np.abs(mean - x).max() < 0.08
    assert np.abs(mean - mean_ref).max() < 0.12
    assert abs((mean - x).mean()) < 0.01
    # through qlinear(impl="qdq"): a stochastic spec no longer raises, and
    # two salts draw different noise
    spec = TSpec("fp4_e2m1", "block", stochastic=True)
    xs = torch.from_numpy(_operand((64, 256), 23))
    assert not torch.equal(
        t_qdq(xs, spec, 1, generator=torch.Generator().manual_seed(1)),
        t_qdq(xs, spec, 1, generator=torch.Generator().manual_seed(2)))


# ---------------------------------------------------------------------------
# The stats epilogue
# ---------------------------------------------------------------------------

def _jax_panels_stats(x, mode, fmt, trans, dtype):
    fn = jax.jit(lambda t: j_fm.quantize_panels(
        t, mode=mode, fmt_name=fmt, trans=trans, collect_stats=True,
        real_dims=(x.shape[::-1] if trans else x.shape)))
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    pad = [(0, -d % 128) for d in x.shape]
    xj = jnp.pad(xj, pad)
    return fn.lower(xj).compile(NO_EXCESS_PRECISION)(xj)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,fmt,trans", [("block", "fp4_e2m1", False),
                                            ("tile", "fp4_e2m1", True),
                                            ("token", "fp8_e4m3", False),
                                            ("tensor", "fp8_e5m2", True)])
def test_quantize_stats_match_jax(mode, fmt, trans, dtype):
    """The quantize pass's stats vector on a ragged 200 x 300 operand
    (JAX zero-pads it and masks the padding with ``real_dims``), and the
    finalized stats."""
    x = _operand((200, 300), 24)
    q_ref, s_ref = _jax_panels_stats(x, mode, fmt, trans, dtype)
    _, xt = _both(x, dtype)
    q, s = t_fm.quantize_panels(xt, mode=mode, fmt_name=fmt, trans=trans,
                                collect_stats=True)
    rows, cols = q.shape
    _assert_bitwise(np.asarray(q_ref.astype(jnp.float32))[:rows, :cols], q)
    _assert_stats(s_ref, s, dtype)
    fin_ref = j_fm.finalize_quant_stats(jnp.asarray(_np(s)))
    fin = t_fm.finalize_quant_stats(s)
    assert set(fin) == set(fin_ref)
    for key in ("clip", "underflow", "rel_err"):
        _assert_bitwise(fin_ref[key], fin[key])
    # log2 is not correctly rounded in XLA (nor in PyTorch): one f32 ulp
    np.testing.assert_allclose(_np(fin["scale_spread"]),
                               _np(fin_ref["scale_spread"]), rtol=2.4e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SR_CASES[:2],
                         ids=lambda c: f"ta{int(c[0])}tb{int(c[1])}-{c[2]}"
                         f"-{c[4]}")
def test_pallas_qmm_stats_match_jax(case, dtype):
    """``pallas_qmm(collect_stats=True)`` with SR, stream pipeline: both
    operands' stats against JAX, and the port's two pipelines bitwise
    equal on y and on both stats vectors."""
    trans_a, trans_b, ma, fa, mb, fb = case
    m, k, n = 200, 256, 130
    a = _operand((k, m) if trans_a else (m, k), 25)
    b = _operand((n, k) if trans_b else (k, n), 26, 0.05)
    kw = dict(mode_a=ma, mode_b=mb, trans_a=trans_a, trans_b=trans_b,
              salt=4, pipeline="stream", collect_stats=True)
    sj = (JSpec(fa, ma, stochastic=True), JSpec(fb, mb, stochastic=True))
    st = (TSpec(fa, ma, stochastic=True), TSpec(fb, mb, stochastic=True))

    def jfn(a_, b_):
        return j_pallas_qmm(a_, b_, *sj, key_data=jnp.asarray(KEY), **kw)
    (aj, at), (bj, bt) = _both(a, dtype), _both(b, dtype)
    _, stats_j = jax.jit(jfn).lower(aj, bj).compile(NO_EXCESS_PRECISION)(
        aj, bj)
    y, stats_t = t_pallas_qmm(at, bt, *st, key_data=KEY, **kw)
    for sj_, st_ in zip(stats_j, stats_t):
        _assert_stats(sj_, st_, dtype)
    y2, stats_2 = t_pallas_qmm(at, bt, *st, key_data=KEY,
                               **{**kw, "pipeline": "two_pass"})
    assert torch.equal(y, y2)
    for s1, s2 in zip(stats_t, stats_2):
        assert torch.equal(s1, s2)


# ---------------------------------------------------------------------------
# The standalone quantizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("shape", [(200, 300), (1, 130), (256, 128)])
def test_quantize_blockwise_matches_jax(shape, per_row, dtype):
    """``kernels.ops.quantize_blockwise`` (tile or per-row groups, ragged
    shapes: JAX pads to 128 and slices back, the port masks), bitwise."""
    x = _operand(shape, 27) if shape[0] > 1 else \
        np.random.default_rng(27).standard_normal(shape).astype(np.float32)
    xj, xt = _both(x, dtype)
    for fmt in ("fp4_e2m1", "fp8_e4m3"):
        _assert_bitwise(j_qblock(xj, fmt, per_row=per_row),
                        quantize_blockwise(xt, fmt, per_row=per_row))


def test_underflow_rate_matches_jax():
    x = _operand((64, 256), 28)
    for spec in ("fp4_e2m1@block128", "fp8_e4m3@token", "fp4_e2m1@tile128"):
        ref = j_underflow(jnp.asarray(x), JSpec.from_str(spec))
        got = underflow_rate(torch.from_numpy(x), TSpec.from_str(spec))
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-7)


# ---------------------------------------------------------------------------
# Telemetry taps
# ---------------------------------------------------------------------------

def test_grad_tap_identity_and_probe_rows():
    """``grad_tap`` leaves y and its gradient unchanged; the cotangent's
    stats land in the layer's row of the class probe (the head's in the
    last row), the tap counts and ``gnorm_sq`` as the reference's
    ``_grad_tap_bwd`` computes them."""
    recipe = t_recipe.RECIPES["fine_grained_fp4"].ffn_linear
    rng = np.random.default_rng(29)
    x = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 96)) * 0.05
                          ).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    grads = []
    for telemetry_on in (False, True):
        xl = x.clone().requires_grad_()
        col = collect.TelemetryCollector()
        probes = collect.make_probes(3)
        ctx = (collect.collecting(col, probes) if telemetry_on
               else contextlib.nullcontext())
        with ctx:
            with collect.layer_frame(1), collect.module_scope("ffn"):
                y1 = qlinear(xl, w, recipe, impl="pallas")
            with collect.module_scope("ffn"):
                y2 = qlinear(xl, w, recipe, impl="pallas")
        (y1 + y2).backward(g)
        grads.append((y1.detach(), xl.grad))
        if telemetry_on:
            assert set(col.frame.stats) == {
                f"ffn/mm0/{slot}/{stat}"
                for slot in ("fwd_x", "fwd_w", "wgrad_x", "dgrad_w")
                for stat in ("clip", "underflow", "rel_err", "scale_spread")}
            pg = probes["ffn"].grad
            assert pg.shape == (4, collect.PROBE_SIZE)
            assert pg[0].abs().sum() == 0 and pg[2].abs().sum() == 0
            assert float(pg[1, -1]) == float(pg[3, -1]) == 1.0
            ref = j_collect._grad_tap_bwd(
                j_recipe_of(recipe), None, jnp.asarray(g.numpy()))[1]
            np.testing.assert_allclose(pg[1].numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-7)
            assert probes["attn"].grad is None
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])


def j_recipe_of(recipe):
    from repro.core.recipe import MatmulRecipe as JRecipe
    return JRecipe(**{f: JSpec.from_str(getattr(recipe, f).to_str())
                      for f in ("fwd_x", "fwd_w", "dgrad_g", "dgrad_w",
                                "wgrad_x", "wgrad_g")})


# ---------------------------------------------------------------------------
# The slice as a whole: the telemetry Trainer
# ---------------------------------------------------------------------------

# Stats bars of the trainer comparison (port vs JAX, same parameters and
# batches).  Step 0 (same inputs): forward-side stats to rtol 1e-5 /
# rates exact to 1e-6; backward-side rates within 5e-4 (the cotangents
# differ in f32 summation order, which flips a few of ~10^4 sampled
# elements across the FP4 underflow edge: this comparison read 2e-5);
# gradient norms and gout_norm to rtol 1e-5.  Later steps, after the
# runs' FP4 / FP8 flips (paper_fp4 read: rel_err 3.0e-2, scale_spread
# 9.8e-2 relative, rates 2.3e-3 absolute): every stat within rtol 0.2 +
# atol 5e-3, and taps exact.
def _assert_rows_close(jr, tr, step):
    assert set(jr) == set(tr), set(jr) ^ set(tr)
    for key, ref in jr.items():
        if key in ("recipe", "straggler", "dt", "step") or \
                not key.startswith("tel/"):
            continue
        got, ref = float(tr[key]), float(ref)
        stat = key.rsplit("/", 1)[1]
        if stat == "taps":
            assert got == ref, key
        elif step > 0:
            np.testing.assert_allclose(got, ref, rtol=0.2, atol=5e-3,
                                       err_msg=key)
        elif stat in ("clip", "underflow"):
            atol = 5e-4 if key.startswith("tel/bwd/") else 1e-6
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol,
                                       err_msg=key)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12,
                                       err_msg=key)


@pytest.mark.parametrize("recipe", ["fine_grained_fp4", "paper_fp4"])
def test_trainer_telemetry_matches_jax(recipe, tmp_path):
    """``tiny`` (f32, 2 x 128 tokens, both impls "pallas"), 2 steps with
    ``telemetry=True`` every step and a JSONL log, against the JAX
    ``Trainer`` (unrolled) from the same parameters: the same metric keys
    every step, losses to LOSS_RTOL (step 0: 1e-6), stats to the bars
    above; one JSONL row per step with the history's keys."""
    over = dict(dtype="float32", linear_impl="pallas",
                attention_impl="pallas", scan_layers=False)
    jcfg = importlib.import_module("repro.configs.tiny").CONFIG.replace(
        **over)
    tcfg = importlib.import_module(
        "repro_torch.configs.tiny").CONFIG.replace(**over)
    kw = dict(recipe=recipe, total_steps=2, global_batch=2, seq_len=128,
              telemetry=True)
    log = str(tmp_path / "tel.jsonl")
    jtr = JTrainer(j_build(jcfg), JTrainConfig(**kw),
                   JSynthetic(jcfg.vocab_size, 128, 2, seed=0))
    ttr = Trainer(t_build(tcfg, "cpu"),
                  TrainConfig(**kw, telemetry_jsonl=log, profiler_warmup=1),
                  SyntheticLM(tcfg.vocab_size, 128, 2, seed=0))
    jstate = jtr.init_state()
    tstate = ttr.init_state(params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    jtr.train(jstate)
    ttr.train(tstate)
    for step, (jr, tr) in enumerate(zip(jtr.history, ttr.history)):
        _assert_rows_close(jr, tr, step)
        np.testing.assert_allclose(tr["loss"], jr["loss"],
                                   rtol=1e-6 if step == 0 else LOSS_RTOL)
    assert any(k.startswith("tel/l01/ffn/mm1/fwd_x/") for k in tr)
    assert "tel/bwd/l01/ffn/wgrad_g/rel_err" in tr
    rows = read_jsonl(log)
    ttr.close()
    assert [r["step"] for r in rows] == [0, 1]
    assert all(set(r) == set(h) for r, h in zip(rows, ttr.history))
    summary = ttr.step_time_summary()
    assert summary["steps"] == 1 and summary["warmup"] == 1


def test_telemetry_every_samples_steps():
    """``telemetry_every=2``: steps 0 and 2 carry the stats, step 1 is the
    plain step with the same metrics as a telemetry-off trainer's."""
    cfg = importlib.import_module("repro_torch.configs.tiny").CONFIG.replace(
        dtype="float32", linear_impl="pallas")
    kw = dict(recipe="paper_fp4", total_steps=3, global_batch=2, seq_len=64)
    runs = []
    for tel in (dict(telemetry=True, telemetry_every=2), {}):
        tr = Trainer(t_build(cfg, "cpu"), TrainConfig(**kw, **tel),
                     SyntheticLM(cfg.vocab_size, 64, 2, seed=0))
        tr.train()
        runs.append(tr.history)
    tel_keys = [any(k.startswith("tel/") for k in r) for r in runs[0]]
    assert tel_keys == [True, False, True]
    assert not any(k.startswith("tel/") for r in runs[1] for k in r)
    for a, b in zip(runs[0], runs[1]):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
