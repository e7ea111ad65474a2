"""The port's training slice against the JAX reference, on the CPU.

JAX runs its Pallas kernels in interpret mode (their CPU default) and its
models unrolled (``scan_layers=False``); the port runs on the CPU, where
every kernel wrapper takes its plain version.  Inputs come from numpy.
Bars, each stated at its test:

* QDQ panels in the transposed (dgrad / wgrad) orientations: bitwise.
* Quantized products: f32 rtol 1e-5 / atol 1e-5 * max|y|; bf16 one bf16
  ulp (2^-7 |y|) + 1e-5 * max|y| (only the f32 summation order differs).
* Attention and gradients: allclose, tolerances at each test.
* Data batches bitwise; LR, clipping and one AdamW update within 1e-6.
* The 8-step trainer on ``tiny``: per-step loss, switch step, final
  parameters, at the tolerances of ``test_trainer_matches_jax``.
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import recipe as j_recipe  # noqa: E402
from repro.core.quantize import QuantSpec as JSpec  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSynthetic  # noqa: E402
from repro.kernels.ops import pallas_qmm as j_pallas_qmm  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.optim import adamw as j_adamw  # noqa: E402
from repro.optim import clip_by_global_norm as j_clip  # noqa: E402
from repro.optim import warmup_cosine as j_warmup_cosine  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.qlinear import qlinear as t_qlinear  # noqa: E402
from repro_torch.core import recipe as t_recipe  # noqa: E402
from repro_torch.core.quantize import QuantSpec as TSpec  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.kernels import fp4_matmul as t_fm  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.kernels import flash_attention as t_flash  # noqa: E402
from repro_torch.kernels.ops import pallas_qmm as t_pallas_qmm  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.optim import adamw, clip_by_global_norm  # noqa: E402
from repro_torch.optim import warmup_cosine  # noqa: E402
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

j_fm = importlib.import_module("repro.kernels.fp4_matmul")
j_flash = importlib.import_module("repro.kernels.flash_attention")
j_ops = importlib.import_module("repro.kernels.ops")
j_qlinear = importlib.import_module("repro.core.qlinear")

T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


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


def _assert_gemm_close(j, t, dtype):
    ref, got = _np(j), _np(t)
    assert got.shape == ref.shape
    top = np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= RTOL[dtype] * np.abs(ref)
                  + 1e-5 * top), float(np.abs(got - ref).max())


# ---------------------------------------------------------------------------
# The three GEMM kernels in the transposed (dgrad / wgrad) layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,fmt", [("block", "fp8_e5m2"),
                                      ("tile", "fp4_e2m1"),
                                      ("token", "fp8_e4m3")])
def test_transposed_quantize_panels_bitwise(mode, fmt, dtype):
    """The quantize pass reading the stored operand transposed (wgrad's
    x^T, the weight's (N, K) orientation), with a ragged reduction axis:
    stored (200, 256), effective (256, 200).  JAX takes it zero-padded to
    (256, 256) and sliced back, which is what the port's masking equals.
    fp8_e5m2 is the gradients' format, the first with two mantissa bits."""
    x = (np.random.default_rng(10).standard_normal((200, 256)) * 3
         ).astype(np.float32)
    x[:, 5] = 0                      # one all-zero effective row
    xj, xt = _both(x, dtype)
    xj_pad = jnp.pad(xj, ((0, 56), (0, 0)))
    ref = j_fm.quantize_panels(xj_pad, mode=mode, fmt_name=fmt,
                               trans=True)[:, :200]
    _assert_bitwise(ref, t_fm.quantize_panels(xt, mode=mode, fmt_name=fmt,
                                              trans=True))


# (trans_a, trans_b, mode_a, fmt_a, mode_b, fmt_b): wgrad reads A = x
# transposed, dgrad reads B = w transposed; the paper's roles and the
# other modes the kernels take.
TRANS_CASES = [
    (True, False, "block", "fp8_e4m3", "block", "fp8_e5m2"),   # FFN wgrad
    (True, False, "token", "fp8_e4m3", "token", "fp8_e5m2"),   # attn wgrad
    (True, False, "tile", "fp4_e2m1", "pass", "bf16"),
    (False, True, "pass", "bf16", "pass", "bf16"),             # FFN dgrad
    (False, True, "token", "fp8_e5m2", "token", "fp8_e4m3"),   # attn dgrad
    (False, True, "block", "fp4_e2m1", "tile", "fp4_e2m1"),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", TRANS_CASES,
                         ids=lambda c: f"ta{int(c[0])}-{c[2]}-{c[4]}")
def test_pallas_qmm_transposed_matches_jax(case, dtype):
    """``pallas_qmm`` with trans_a / trans_b against the JAX wrapper
    (Pallas interpret mode), effective 200 x 256 x 128: M ragged, K a
    reduction of two groups.  Products to the GEMM bar."""
    trans_a, trans_b, ma, fa, mb, fb = case
    m, k, n = 200, 256, 128
    rng = np.random.default_rng(11)
    a = (rng.standard_normal((k, m) if trans_a else (m, k)) * 2
         ).astype(np.float32)
    b = (rng.standard_normal((n, k) if trans_b else (k, n)) * 0.05
         ).astype(np.float32)
    (aj, at), (bj, bt) = _both(a, dtype), _both(b, dtype)
    specs = [(s(fa, ma) if ma != "pass" else s("bf16"),
              s(fb, mb) if mb != "pass" else s("bf16"))
             for s in (JSpec, TSpec)]
    kw = dict(mode_a=ma, mode_b=mb, trans_a=trans_a, trans_b=trans_b)
    _assert_gemm_close(j_pallas_qmm(aj, bj, *specs[0], **kw),
                       t_pallas_qmm(at, bt, *specs[1], **kw), dtype)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(4, 128, 16), (2, 256, 64), (2, 128, 32),
                                   (1, 128, 128)])
def test_flash_attention_fwd_matches_jax(shape, dtype):
    """The kernel's forward (plain version here) against the reference
    kernel in interpret mode.  f32: rtol/atol 1e-5 (summation order of
    the two products); bf16: the f32 result rounds to bf16 on both
    sides, within one bf16 ulp (2^-7) plus 1e-5."""
    rng = np.random.default_rng(12)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for _ in range(3))
    (qj, qt), (kj, kt), (vj, vt) = (_both(x, dtype) for x in (q, k, v))
    ref = j_flash.flash_attention_fwd(qj, kj, vj, interpret=True)
    got = t_flash.flash_attention_fwd(qt, kt, vt)
    assert got.dtype == T_DT[dtype]
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol, atol=1e-5)


@pytest.mark.parametrize("rep", [1, 2])
def test_flash_attention_grads_match_jax(rep):
    """``ops.flash_attention`` (kernel forward, chunked backward) against
    the reference's ``flash_attention`` and ``jax.vjp``, (B, S, H, D) =
    (2, 128, 4, 16) with 4 / rep KV heads, f32: forward rtol/atol 1e-5,
    gradients 1e-4 (the backward recomputes softmax, summation orders
    differ)."""
    rng = np.random.default_rng(13)
    b, s, h, d = 2, 128, 4, 16
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, h // rep, d)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def jfn(q, k, v):
        return j_ops.flash_attention(q, k, v, chunk=64, interpret=True)
    out_j, vjp = jax.vjp(jfn, *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out_t = t_ops.flash_attention(*leaves, chunk=64)
    out_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=1e-5, atol=1e-5)
    for gj, lt in zip(grads_j, leaves):
        np.testing.assert_allclose(_np(lt.grad), _np(gj), rtol=1e-4,
                                   atol=1e-4)


# ---------------------------------------------------------------------------
# qlinear: forward and the STE backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["MM_FP8", "MM_FFN_PAPER"])
def test_qlinear_grads_match_jax(name, dtype):
    """y, dx and dw of ``qlinear(impl="pallas")`` against ``jax.vjp`` of
    ``pallas_qmatmul``: fwd, dgrad (w read transposed) and wgrad (x read
    transposed), x (150, 256) with M ragged, w (256, 128).  Each to the
    GEMM bar of its dtype; dx, dw come back in x's and w's dtypes."""
    rng = np.random.default_rng(14)
    x = (rng.standard_normal((150, 256)) * 2).astype(np.float32)
    w = (rng.standard_normal((256, 128)) * 0.05).astype(np.float32)
    g = rng.standard_normal((150, 128)).astype(np.float32)
    (xj, xt), (wj, wt), (gj, gt) = (_both(a, dtype) for a in (x, w, g))
    rj, rt = getattr(j_recipe, name), getattr(t_recipe, name)
    y_j, vjp = jax.vjp(lambda x, w: j_qlinear.pallas_qmatmul(
        x, w, jnp.zeros((2,), jnp.uint32), rj), xj, wj)
    dx_j, dw_j = vjp(gj)
    xt.requires_grad_()
    wt.requires_grad_()
    y_t = t_qlinear(xt, wt, rt, impl="pallas")
    y_t.backward(gt)
    assert (xt.grad.dtype, wt.grad.dtype) == (xt.dtype, wt.dtype)
    for j, t in ((y_j, y_t), (dx_j, xt.grad), (dw_j, wt.grad)):
        _assert_gemm_close(j, t, dtype)


# ---------------------------------------------------------------------------
# Data, schedule, clipping, optimizer
# ---------------------------------------------------------------------------

def test_synthetic_batches_bitwise():
    j, t = JSynthetic(50257, 64, 4, seed=3), SyntheticLM(50257, 64, 4, seed=3)
    for step in (0, 1, 10_000_000):
        bj, bt = j.batch(step), t.batch(step)
        for key in ("tokens", "targets"):
            assert bj[key].dtype == bt[key].dtype == np.int32
            assert np.array_equal(bj[key], bt[key])


def test_lr_clip_and_adamw_match_jax():
    """warmup_cosine over a run, clip_by_global_norm and one AdamW update
    (matrix and vector leaves, so decay on matrices only) against the
    reference, rtol/atol 1e-6."""
    jl, tl = (f(6e-4, 200, 0.05, 0.1) for f in (j_warmup_cosine,
                                                warmup_cosine))
    for step in (0, 5, 9, 10, 11, 100, 199):
        np.testing.assert_allclose(float(tl(step)),
                                   float(jl(jnp.asarray(step))), rtol=1e-6)
    rng = np.random.default_rng(15)
    p = {"w": rng.standard_normal((8, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    g = {k: (rng.standard_normal(v.shape) * 3).astype(np.float32)
         for k, v in p.items()}
    gj, nj = j_clip({k: jnp.asarray(v) for k, v in g.items()}, 1.0)
    gt, nt = clip_by_global_norm({k: torch.from_numpy(v)
                                  for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(float(nt), float(nj), rtol=1e-6)
    for key in p:
        np.testing.assert_allclose(_np(gt[key]), _np(gj[key]), rtol=1e-6,
                                   atol=1e-6)
    jopt, topt = j_adamw(), adamw()
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    sj, st = jopt.init(pj), topt.init(pt)
    for lr in (3e-4, 2e-4):                  # two updates: count 1 and 2
        pj, sj = jopt.update(gj, sj, pj, jnp.float32(lr))
        pt, st = topt.update(gt, st, pt, torch.tensor(lr))
    for key in p:
        np.testing.assert_allclose(_np(pt[key]), _np(pj[key]), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(_np(st.nu[key]), _np(sj.nu[key]),
                                   rtol=1e-6, atol=1e-9)


# ---------------------------------------------------------------------------
# The slice as a whole: the Trainer
# ---------------------------------------------------------------------------

# Trainer bars (f32, port vs JAX from the same parameters on the same
# batches): relative per-step loss, relative grad norm, absolute final
# parameters.  Under bf16 nothing is quantized and the runs differ by f32
# summation order alone (this comparison read: loss 2.4e-7, params
# 5.3e-6).  Under paper_fp4 the step-0 loss agrees (read 0), and then an
# FP4 / FP8 rounding of an input that differs in its last bit now and then
# moves one element by a whole grid step, and the optimizer carries such
# flips on (read: loss 4.0e-3, grad norm 1.1e-2, params 2.7e-3, lr
# 2.5e-7).
TRAIN_TOL = {
    "paper_fp4": dict(loss=1e-2, grad_norm=3e-2, params=1e-2),
    "bf16": dict(loss=1e-5, grad_norm=1e-5, params=1e-4),
}


@pytest.mark.parametrize("recipe", ["paper_fp4", "bf16"])
def test_trainer_matches_jax(recipe):
    """``tiny`` (llama family, GQA 4 / 2), f32, global batch 2 x 128 (the
    flash route: S % 128 == 0), 8 steps with ``linear_impl`` and
    ``attention_impl`` "pallas".  Params built in JAX and carried across
    with ``params_from_jax``.  ``paper_fp4`` is the slice; ``bf16`` runs
    the same trainer, flash kernel and optimizer with no quantization, so
    it holds everything but the FP4 / FP8 flips to a tight bar.  Holds
    the per-step losses, grad norms and LRs, the switch step (7 for
    paper_fp4, with step 7 on the bf16 plan; never for bf16) and the
    final parameters to TRAIN_TOL."""
    tol = TRAIN_TOL[recipe]
    over = dict(dtype="float32", linear_impl="pallas",
                attention_impl="pallas", scan_layers=False)
    jcfg = importlib.import_module("repro.configs.tiny").CONFIG.replace(
        **over)
    tcfg = importlib.import_module(
        "repro_torch.configs.tiny").CONFIG.replace(**over)
    kw = dict(recipe=recipe, total_steps=8, global_batch=2, seq_len=128)
    jtr = JTrainer(j_build(jcfg), JTrainConfig(**kw),
                   JSynthetic(jcfg.vocab_size, 128, 2, seed=0))
    ttr = Trainer(t_build(tcfg, "cpu"), TrainConfig(**kw),
                  SyntheticLM(tcfg.vocab_size, 128, 2, seed=0))
    jstate = jtr.init_state()
    tstate = ttr.init_state(params=params_from_jax(
        jax.tree.map(np.asarray, jstate.params), tcfg))
    jstate = jtr.train(jstate)
    tstate = ttr.train(tstate)
    switch = 7 if recipe == "paper_fp4" else 8
    assert ttr.schedule.switch_step == jtr.schedule.switch_step == switch
    assert [r["recipe"] for r in ttr.history] == \
        [r["recipe"] for r in jtr.history] == \
        [recipe] * switch + ["bf16"] * (8 - switch)
    hist = {key: [np.array([r[key] for r in h.history]) for h in (ttr, jtr)]
            for key in ("loss", "grad_norm", "lr", "tokens")}
    np.testing.assert_allclose(hist["loss"][0][0], hist["loss"][1][0],
                               rtol=1e-6)
    for key, rtol in (("loss", tol["loss"]),
                      ("grad_norm", tol["grad_norm"]), ("lr", 1e-6),
                      ("tokens", 0)):
        np.testing.assert_allclose(*hist[key], rtol=rtol, err_msg=key)
    ref = params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg)
    got = jax.tree.leaves(jax.tree.map(_np, tstate.params))
    want = jax.tree.leaves(jax.tree.map(_np, ref))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol["params"])


def test_trainer_refuses_unported_features(tmp_path):
    """Every TrainConfig field of a feature the port has not got raises
    instead of being ignored (telemetry, its JSONL log and the step
    timer's warm-up are ported: test_torch_telemetry; checkpoints, the
    plan presets, remat, ``loss_chunk`` and adafactor: the tests below
    and test_torch_checkpoint; the controller and its cost calibration:
    test_torch_controller; fp8 gradient compression and data-parallel
    meshes: test_torch_spmd_train; the model axis of a dense stack:
    test_torch_tensor_parallel).  ``grad_compression`` and
    ``mesh_shape`` are accepted; a ``model`` axis larger than 1 raises
    for a model the port does not split over it (whisper here; an MoE
    model and mamba split: test_torch_expert_parallel,
    test_torch_ssm_parallel), and so does a mesh larger
    than the world.
    ``remat_policy="dots"`` raises: no selective-checkpoint policy sees
    the port's matmul kernels."""
    import torch.distributed as dist
    from repro_torch.distributed import AbstractMesh, default_rules
    cfg = importlib.import_module("repro_torch.configs.tiny").CONFIG
    model = t_build(cfg, "cpu")
    pipe = SyntheticLM(cfg.vocab_size, 128, 2)
    audio = importlib.import_module(
        "repro_torch.configs.whisper_base").REDUCED
    with pytest.raises(NotImplementedError, match="queue A"):
        Trainer(t_build(audio, "cpu"), TrainConfig(), pipe,
                rules=default_rules(AbstractMesh((1, 2),
                                                 ("data", "model")), audio))
    Trainer(model, TrainConfig(grad_compression="fp8"), pipe)
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        tr = Trainer(model, TrainConfig(mesh_shape=(1, 1)), pipe)
        assert tr.rules.dp_size == 1 and tr.dp is None
        with pytest.raises(ValueError, match="need 2 devices, have 1"):
            Trainer(model, TrainConfig(mesh_shape=(2, 1)), pipe)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError):
        Trainer(model, TrainConfig(plan_preset="nope"), pipe)
    dots = t_build(cfg.replace(dtype="float32", remat_policy="dots"), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch(0).items()}
    params = dots.init(0)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    with pytest.raises(NotImplementedError):
        dots.loss(params, batch, t_recipe.RECIPES["bf16"])


# ---------------------------------------------------------------------------
# The rest of training: remat, loss_chunk, adafactor, data, API gaps
# ---------------------------------------------------------------------------

def _tiny(**over):
    kw = dict(dtype="float32", linear_impl="pallas",
              attention_impl="pallas", **over)
    return (importlib.import_module("repro.configs.tiny").CONFIG.replace(
        **kw), importlib.import_module("repro_torch.configs.tiny").CONFIG
        .replace(**kw))


def _loss_and_grads(model, params, batch, plan):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = model.loss(params, batch, plan)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss.detach(), metrics, grads


@pytest.mark.parametrize("recipe", ["paper_fp4", "fine_grained_fp4"])
def test_remat_changes_no_numbers(recipe):
    """Per-layer remat (``remat_policy="full"``) against ``remat=False``
    on ``tiny`` (f32, the kernels' plain versions): loss and every
    gradient bitwise equal; "none" is remat off."""
    _, cfg = _tiny()
    pipe = SyntheticLM(cfg.vocab_size, 128, 2, seed=1)
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch(0).items()}
    params = t_build(cfg, "cpu").init(5)
    outs = [_loss_and_grads(t_build(cfg.replace(**over), "cpu"), params,
                            batch, t_recipe.RECIPES[recipe])
            for over in (dict(remat=True), dict(remat=False),
                         dict(remat=True, remat_policy="none"))]
    for loss, _, grads in outs[1:]:
        assert loss.numpy().tobytes() == outs[0][0].numpy().tobytes()
        for a, b in zip(grads, outs[0][2]):
            assert a.numpy().tobytes() == b.numpy().tobytes()


def test_remat_telemetry_rows_equal():
    """Instrumented fine_grained_fp4 ``Trainer`` steps with remat on and
    off: every telemetry stat of the rows bitwise equal (the recompute
    runs its taps under a throwaway collector), 4 / 3 taps a layer (the
    attention's four linears, swiglu's three; none doubled), and the
    losses equal."""
    _, cfg = _tiny()
    rows = []
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        tr = Trainer(t_build(c, "cpu"), TrainConfig(
            recipe="fine_grained_fp4", total_steps=8, global_batch=2,
            seq_len=128, telemetry=True, log_every=0),
            SyntheticLM(c.vocab_size, 128, 2, seed=0))
        tr.train(tr.init_state(seed=0), num_steps=2)
        rows.append(tr.history)
    for on, off in zip(*rows):
        keys = sorted(k for k in off if k.startswith("tel/") or k in
                      ("loss", "grad_norm"))
        assert len(keys) > 100 and sorted(k for k in on if k in keys) == keys
        assert [on[k] for k in keys] == [off[k] for k in keys]
        for i in range(cfg.n_layers):
            assert on[f"tel/bwd/l{i:02d}/attn/taps"] == 4.0
            assert on[f"tel/bwd/l{i:02d}/ffn/taps"] == 3.0


def test_loss_chunk_matches_jax_and_unchunked():
    """``loss_chunk`` = 32 over S = 128 (four rematerialized head + xent
    chunks): the loss within rtol 1e-5 of the reference's chunked loss
    from the same parameters; against the port's unchunked loss the loss
    within rtol 1e-6 and every gradient within rtol 1e-5 / atol 1e-7 (the
    chunk sums add in another order); S not a multiple of the chunk
    raises."""
    jcfg, cfg = _tiny(loss_chunk=32, scan_layers=False)
    jmodel = j_build(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(2), jnp.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    b = JSynthetic(cfg.vocab_size, 128, 2, seed=3).batch(0)
    b["targets"][0, :7] = -1                 # masked positions
    jl = jmodel.loss(jparams, {k: jnp.asarray(v) for k, v in b.items()},
                     j_recipe.RECIPES["paper_fp4"])[0]
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    plan = t_recipe.RECIPES["paper_fp4"]
    lc, mc, gc = _loss_and_grads(t_build(cfg, "cpu"), params, batch, plan)
    lu, mu, gu = _loss_and_grads(t_build(cfg.replace(loss_chunk=0), "cpu"),
                                 params, batch, plan)
    np.testing.assert_allclose(float(lc), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(lc), float(lu), rtol=1e-6)
    assert float(mc["tokens"]) == float(mu["tokens"]) == 2 * 128 - 7
    for a, g in zip(gc, gu):
        np.testing.assert_allclose(a.numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-7)
    with pytest.raises(ValueError):
        t_build(cfg.replace(loss_chunk=48), "cpu").loss(params, batch, plan)


def test_adafactor_matches_jax():
    """Three Adafactor updates (a matrix, a stacked (layers, K, N) leaf
    and a vector; weight decay on) against the reference's, through
    ``get_optimizer`` with the trainer's arguments: params and factors
    within rtol 1e-5 / atol 1e-7."""
    from repro.optim import get_optimizer as j_get
    from repro_torch.optim import get_optimizer as t_get
    kw = dict(weight_decay=0.1, beta1=0.9, beta2=0.95, eps=1e-8)
    jopt, topt = j_get("adafactor", **kw), t_get("adafactor", **kw)
    rng = np.random.default_rng(16)
    shapes = {"w": (8, 6), "stack": (3, 4, 5), "b": (6,)}
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in shapes.items()}
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    sj, st = jopt.init(pj), topt.init(pt)
    for i, lr in enumerate((1e-2, 5e-3, 2e-3)):
        g = {k: (rng.standard_normal(s) * (i + 1)).astype(np.float32)
             for k, s in shapes.items()}
        pj, sj = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, sj,
                             pj, jnp.float32(lr))
        pt, st = topt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             st, pt, lr)
    assert st.count == int(sj.count) == 3
    for k in shapes:
        for a, b in ((pt[k], pj[k]), (st.vr[k], sj.vr[k]),
                     (st.vc[k], sj.vc[k])):
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5,
                                       atol=1e-7)


def test_byte_corpus_and_make_pipeline_bitwise():
    from repro.data.pipeline import ByteCorpus as JBytes
    from repro.data.pipeline import make_pipeline as j_make
    from repro_torch.data import ByteCorpus, make_pipeline
    pairs = [(JBytes(64, 4, seed=2), ByteCorpus(64, 4, seed=2)),
             (JBytes(32, 2, text="abc" * 40), ByteCorpus(32, 2,
                                                         text="abc" * 40))]
    pairs += [(j_make(k, 300, 48, 2, seed=5), make_pipeline(k, 300, 48, 2,
                                                           seed=5))
              for k in ("synthetic", "bytes")]
    for j, t in pairs:
        assert type(t).__name__ == type(j).__name__
        for step in (0, 3, 10_000_000):
            for host in (0, 1):
                bj, bt = j.batch(step, host, 2), t.batch(step, host, 2)
                for key in ("tokens", "targets"):
                    assert bj[key].dtype == bt[key].dtype == np.int32
                    assert np.array_equal(bj[key], bt[key])
    with pytest.raises(ValueError):
        make_pipeline("files", 300, 48, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp4_matmul_and_pipelines_match_jax(dtype):
    """``kernels.ops.fp4_matmul`` (block x tile fp4, ragged 130 x 200 x
    96) against the reference's within the GEMM bar; ``use_pipeline``
    sets ``default_pipeline`` as the reference's does (nested, unwound),
    and ``fused_qmm`` under it equals the explicit pipeline bitwise."""
    rng = np.random.default_rng(17)
    x = (rng.standard_normal((130, 200)) * 2).astype(np.float32)
    w = (rng.standard_normal((200, 96)) * 0.05).astype(np.float32)
    (xj, xt), (wj, wt) = _both(x, dtype), _both(w, dtype)
    _assert_gemm_close(j_ops.fp4_matmul(xj, wj, x_fmt="fp4_e2m1",
                                        w_fmt="fp8_e4m3"),
                       t_ops.fp4_matmul(xt, wt, x_fmt="fp4_e2m1",
                                        w_fmt="fp8_e4m3"), dtype)
    assert t_fm.default_pipeline() == j_fm.default_pipeline() == "stream"
    with t_fm.use_pipeline("two_pass"), j_fm.use_pipeline("two_pass"):
        assert t_fm.default_pipeline() == j_fm.default_pipeline()
        with t_fm.use_pipeline("stream"), j_fm.use_pipeline("stream"):
            assert t_fm.default_pipeline() == j_fm.default_pipeline()
        y = t_fm.fused_qmm(xt, wt)
        assert t_fm.default_pipeline() == "two_pass"
    assert t_fm.default_pipeline() == "stream"
    _assert_bitwise(y, t_fm.fused_qmm(xt, wt, pipeline="two_pass"))
    with pytest.raises(ValueError):
        with t_fm.use_pipeline("nope"):
            pass


def test_bits_per_param_matches_jax():
    from repro.core.packed import pack_tensor as j_pack
    from repro_torch.core.packed import pack_tensor as t_pack
    w = np.random.default_rng(18).standard_normal((200, 96)).astype(
        np.float32)
    for spec in ("fp4_e2m1@tile128", "fp8_e4m3@tile128", "fp4_e2m1@tile64"):
        jp = j_pack(jnp.asarray(w), JSpec.from_str(spec))
        tp = t_pack(torch.from_numpy(w), TSpec.from_str(spec))
        assert tp.nbytes == jp.nbytes
        assert tp.bits_per_param == jp.bits_per_param, spec


@pytest.mark.parametrize("arch", ["tiny", "gpt2_125m"])
def test_embedding_gradient_is_repeatable(arch):
    """One step's embedding gradients (``tiny``: an untied embedding;
    gpt2: a tied one and learned positions), four times over: bitwise
    equal, so CPU training repeats bit for bit.  The lookup is
    ``F.embedding``, whose CPU backward sums a row's gradients in one
    order; an indexing lookup's backward (``index_put_`` with accumulate)
    adds them from several threads in any order."""
    cfg = importlib.import_module(f"repro_torch.configs.{arch}").REDUCED \
        .replace(dtype="float32")
    model = t_build(cfg, "cpu")
    params = model.init(0)
    batch = {k: torch.from_numpy(v) for k, v in
             SyntheticLM(cfg.vocab_size, 64, 8, seed=0).batch(0).items()}
    names = [n for n in ("embed", "pos_embed") if n in params]
    grads = []
    for _ in range(4):
        leaves = {n: params[n].detach().clone().requires_grad_(True)
                  for n in names}
        loss, _ = model.loss({**params, **leaves}, batch,
                             t_recipe.RECIPES["bf16"])
        grads.append(torch.autograd.grad(loss, list(leaves.values())))
    for g in grads[1:]:
        assert all(torch.equal(a, b) for a, b in zip(g, grads[0]))
