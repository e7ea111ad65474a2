"""The port's packed-FP4 serving slice against the JAX reference.

Setup on both sides: ``gpt2_125m.REDUCED`` or ``tiny`` (llama family,
GQA), JAX params carried across with ``repro_torch.convert``, packed
fp4_e2m1 weights, fp8_e4m3 KV cache, recipe ``paper_fp4``,
``linear_impl="pallas"`` (JAX: Pallas kernels in interpret mode; port:
the CUDA kernels' plain versions, on the CPU).

The reference's prefill and decode step are compiled with XLA's
``xla_allow_excess_precision`` off.  With it on (XLA's default), fused bf16
elementwise chains keep f32 intermediates, the reference's bf16 logits
differ from its own op-by-op run in last bits, and FP4 rounding amplifies
that to ~15% of max|logit|; with it off, the port reproduces them bit
for bit.
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train.serving_runtime import DecodeEngine as JEngine  # noqa: E402
from repro.train.serving_runtime import (  # noqa: E402
    quantize_weights_for_serving as j_quantize)
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.recipe import RECIPES as T_RECIPES  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.train.serve import generate  # noqa: E402
from repro_torch.train.serving_runtime import (  # noqa: E402
    ContinuousBatcher, DecodeEngine, quantize_weights_for_serving,
    serving_memory_report)
from torch_dist_workers import torch_threads as torch_threads  # noqa

# Max |logit difference| / max |logit| allowed.  Measured on the CPU:
# f32 <= 5.2e-7 (summation order of the GEMMs); bf16 0 (bitwise).  The
# bf16 bound leaves room for a GEMM-order flip of a bf16 last bit upstream
# of an FP4 group, which moves logits by a few per mille.
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
MAX_LEN = 32
N_STEPS = 4


def _cfgs(arch, dtype):
    over = dict(dtype=dtype, linear_impl="pallas", scan_layers=False)
    j = importlib.import_module(f"repro.configs.{arch}").REDUCED
    t = importlib.import_module(f"repro_torch.configs.{arch}").REDUCED
    return j.replace(**over), t.replace(**over)


def _engines(arch, dtype):
    jcfg, tcfg = _cfgs(arch, dtype)
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
    return jcfg, je, te


def _compiled(fn, *args):
    """``fn`` jitted and compiled for ``args`` without excess precision."""
    return jax.jit(fn).lower(*args).compile(NO_EXCESS_PRECISION)


def _rel(a, b):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.to(torch.float32).numpy()
    return float(np.abs(a - b).max() / np.abs(a).max())


def _assert_engines_agree(arch, dtype, n, n_steps=N_STEPS):
    """Prefill logits of an ``n``-token prompt and ``n_steps`` batched
    decode-step logits of the packed-FP4 engine, port vs reference, under
    the same tokens."""
    jcfg, je, te = _engines(arch, dtype)
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, n)
    bucket = te.bucket(n)
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompt
    jcache = je.model.init_cache(1, MAX_LEN, je.cache_dtype, per_slot=True)
    j_prefill = _compiled(
        lambda p, t, c: je.model.prefill(p, {"tokens": t}, c, je.recipe,
                                         true_length=n),
        je.params, jnp.asarray(padded), jcache)
    jl, jc = j_prefill(je.params, jnp.asarray(padded), jcache)
    tl, tc = te.model.prefill(
        te.params, torch.from_numpy(padded).long(),
        te.model.init_cache(1, MAX_LEN, te.cache_dtype, per_slot=True),
        te.recipe, true_length=n)
    assert _rel(jl, tl) <= TOL[dtype]
    tok = int(jnp.argmax(jl[0, -1].astype(jnp.float32)))
    je.insert(jc, tok, 0)
    te.insert(tc, tok, 0)
    j_decode = _compiled(
        lambda p, t, c: je.model.decode_step(p, t, c, je.recipe),
        je.params, jnp.asarray(je.last_tok[:, None]), je.cache)
    for _ in range(n_steps):
        toks = je.last_tok[:, None].copy()
        jl, je.cache = j_decode(je.params, jnp.asarray(toks), je.cache)
        tl, te.cache = te.model.decode_step(
            te.params, torch.from_numpy(toks).long(), te.cache, te.recipe)
        assert _rel(jl, tl) <= TOL[dtype]
        je.last_tok = np.asarray(jnp.argmax(
            jl[:, -1].astype(jnp.float32), axis=-1)).astype(np.int32)
    return te


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["gpt2_125m", "tiny"])
def test_engine_logits_match_jax(arch, dtype):
    te = _assert_engines_agree(arch, dtype, 11)
    assert te.bucket(11) == 16


def test_full_cache_boundary():
    """A request that fills the cache exactly (a prompt of MAX_LEN - 2,
    two decode steps) agrees with the reference up to the last position.
    One more step would write past the end, which the reference drops:
    the port's engine raises instead, and the batcher refuses a request
    that does not fit."""
    te = _assert_engines_agree("tiny", "float32", MAX_LEN - 2, n_steps=2)
    te.release(0)
    prompt = np.arange(MAX_LEN - 2) % 7
    tok, c1 = te.prefill(prompt)
    te.insert(c1, tok, 1)
    te.generate_step()
    te.generate_step()
    with pytest.raises(RuntimeError, match="max_len"):
        te.generate_step()
    batcher = ContinuousBatcher(te.model, te.params, n_slots=1,
                                max_len=MAX_LEN, device="cpu")
    batcher.submit(prompt, 3)
    with pytest.raises(ValueError, match="max_len"):
        batcher.submit(prompt, 4)


def test_engine_matches_sequential_generate():
    """Bucket-padded prefill + batched per-slot decode == one-at-a-time
    greedy generation, token-exact (the property
    tests/test_decode_engine.py holds for the reference), through the
    packed-FP4 / fp8-KV / paper_fp4 kernel path."""
    _, tcfg = _cfgs("tiny", "bfloat16")
    model = t_build(tcfg, "cpu")
    params = quantize_weights_for_serving(model, model.init(seed=0),
                                          "fp4_e2m1", device="cpu")
    engine = DecodeEngine(model, params, n_slots=3, max_len=MAX_LEN,
                          recipe=T_RECIPES["paper_fp4"],
                          kv_format="fp8_e4m3", min_bucket=8, device="cpu")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in (5, 12, 9)]
    got = []
    for s, p in enumerate(prompts):
        tok, c1 = engine.prefill(p)
        engine.insert(c1, tok, s)
        got.append([tok])
    for _ in range(5):
        nxt = engine.generate_step()
        for s in range(len(prompts)):
            got[s].append(int(nxt[s]))
    for s, p in enumerate(prompts):
        ref = generate(engine.model, engine.params,
                       torch.from_numpy(p)[None], max_new_tokens=6,
                       recipe=engine.recipe)[0, len(p):]
        assert got[s] == ref.tolist(), s


def test_batcher_matches_engine_and_memory_report():
    _, tcfg = _cfgs("gpt2_125m", "bfloat16")
    model = t_build(tcfg, "cpu")
    params = quantize_weights_for_serving(model, model.init(seed=0),
                                          "fp4_e2m1", device="cpu")
    report = serving_memory_report(params)
    # 4-bit codes + one f32 scale per 128x128 tile (at REDUCED widths a
    # tile is mostly padding, so the scale share is larger than at 768).
    assert 0.5 <= report["bytes_per_packed_param"] < 0.6, report
    batcher = ContinuousBatcher(model, params, n_slots=2, max_len=MAX_LEN,
                                recipe=T_RECIPES["paper_fp4"],
                                kv_format="fp8_e4m3", device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab_size, n) for n in (3, 7, 5)]
    ids = [batcher.submit(p, 4) for p in prompts]
    out = batcher.run()
    for rid, p in zip(ids, prompts):
        ref = generate(batcher.engine.model, batcher.engine.params,
                       torch.from_numpy(p)[None], max_new_tokens=4,
                       recipe=batcher.engine.recipe)[0, len(p):]
        assert out[rid] == ref.tolist(), rid


def test_entry_points_refuse_silent_cpu(monkeypatch):
    """With no CUDA device and no explicit CPU request, entry points raise
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs("tiny", "float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build(tcfg)
    model = t_build(tcfg, "cpu")
    params = model.init(seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quantize_weights_for_serving(model, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(model, params)


def test_convert_loads_both_stack_layouts():
    """A scan-stacked (``stack.groups``) reference tree and its unrolled
    (``stack.layers``) form give the same packed serving logits."""
    jcfg, tcfg = _cfgs("tiny", "bfloat16")
    jm = j_build(jcfg.replace(scan_layers=True))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    grouped = params_from_jax(tree, tcfg)
    stacked = tree["stack"]["groups"]["l00"]
    tree["stack"] = {"layers": [
        jax.tree.map(lambda a, i=i: a[i], stacked)
        for i in range(tcfg.n_layers)]}
    unrolled = params_from_jax(tree, tcfg)
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, tcfg.vocab_size, (2, 12)))
    logits = []
    for params, scan in ((grouped, True), (unrolled, False)):
        model = t_build(tcfg.replace(scan_layers=scan), "cpu")
        packed = quantize_weights_for_serving(model, params, "fp4_e2m1",
                                              device="cpu")
        logits.append(model.forward(packed, toks, T_RECIPES["paper_fp4"]))
    assert torch.equal(logits[0], logits[1])
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({**tree, "extra": np.zeros(1)}, tcfg)
