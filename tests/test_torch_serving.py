"""The rest of the port's serving against the JAX reference, on the CPU:
``streaming_prefill``, the sliding-window ring caches of the engine
(``h2o_danube_3_4b.REDUCED``: window 64), the ring guard, the unpacked
(``packed=False``) weights, ``train.serve``'s ``make_prefill_fn`` /
``make_decode_fn`` / ``generate`` (``jit``, ``temperature``), the
device-tensor ``true_length`` prefill and ``launch/serve.py``.

The reference's prefill and decode steps are compiled with XLA's
``xla_allow_excess_precision`` off, as in ``tests/test_torch_decode.py``
(with it on, fused bf16 chains keep f32 intermediates).  Bars: max
|logit difference| / max |logit| within 1e-5 in f32 (summation order of
the GEMMs) and 1e-2 in bf16 (a GEMM-order flip of a bf16 last bit
upstream of an FP4 group); tokens equal; QDQ values and the
``true_length`` forms bitwise.
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train import serve as j_serve  # noqa: E402
from repro.train import serving_runtime as j_rt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.recipe import RECIPES as T_RECIPES  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.train import serve as t_serve  # noqa: E402
from repro_torch.train import serving_runtime as t_rt  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
SWA = "h2o_danube_3_4b"


def _cfgs(arch, dtype, **over):
    over = {"dtype": dtype, "scan_layers": False, **over}
    j = importlib.import_module(f"repro.configs.{arch}").REDUCED
    t = importlib.import_module(f"repro_torch.configs.{arch}").REDUCED
    return j.replace(**over), t.replace(**over)


def _models(arch, dtype, seed=0, **over):
    """Reference and port models with the same parameters."""
    jcfg, tcfg = _cfgs(arch, dtype, **over)
    jm, tm = j_build(jcfg), t_build(tcfg, "cpu")
    jp = jm.init(jax.random.PRNGKey(seed))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), tcfg)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(NO_EXCESS_PRECISION)


def _rel(a, b):
    a = np.asarray(jnp.asarray(a).astype(jnp.float32))
    b = b.to(torch.float32).numpy()
    return float(np.abs(a - b).max() / np.abs(a).max())


def _j_packed(jm, jp):
    """The reference's packed fp4 weights, packed in one compiled call."""
    return jax.jit(lambda p: j_rt.quantize_weights_for_serving(
        jm, p, "fp4_e2m1"))(jp)


def _j_prefill(jm, recipe, true_length=None):
    def fn(p, t, c):
        return jm.prefill(p, {"tokens": t}, c, recipe,
                          true_length=true_length)
    return fn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_streaming_prefill_matches_one_shot_and_reference(dtype):
    """Segments of 16 over 40 tokens (the last one partial) give the
    one-shot prefill's logits and cache, and the reference's."""
    jm, jp, tm, tp = _models("tiny", dtype)
    jr, tr = J_RECIPES["bf16"], T_RECIPES["bf16"]
    toks = np.random.default_rng(0).integers(0, 256, (2, 40))
    jc = jm.init_cache(2, 48)
    for s in range(0, 40, 16):
        seg = jnp.asarray(toks[:, s:s + 16].astype(np.int32))
        jl, jc = _compiled(_j_prefill(jm, jr), jp, seg, jc)(jp, seg, jc)
    tt = torch.from_numpy(toks)
    tl, tc = t_rt.streaming_prefill(tm, tp, tt, tm.init_cache(2, 48), tr,
                                    segment=16)
    ol, oc = tm.prefill(tp, tt, tm.init_cache(2, 48), tr)
    assert _rel(jl, tl) <= TOL[dtype]
    assert int(tc["length"]) == int(jc["length"]) == 40
    if dtype == "float32":
        torch.testing.assert_close(tl, ol, rtol=1e-5, atol=1e-6)
        for a, b in zip(tree_leaves(tc), tree_leaves(oc)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    else:
        assert _rel(ol.float().numpy(), tl) <= TOL[dtype]


def _swa_engines(dtype, max_len=128):
    jm, jp, tm, tp = _models(SWA, dtype, linear_impl="pallas")
    je = j_rt.DecodeEngine(jm, _j_packed(jm, jp), n_slots=2, max_len=max_len,
        recipe=J_RECIPES["paper_fp4"], kv_format="fp8_e4m3")
    te = t_rt.DecodeEngine(tm, t_rt.quantize_weights_for_serving(
        tm, tp, "fp4_e2m1", device="cpu"), n_slots=2, max_len=max_len,
        recipe=T_RECIPES["paper_fp4"], kv_format="fp8_e4m3", device="cpu")
    return je, te


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_windowed_engine_matches_reference_past_the_window(dtype):
    """h2o-danube-3-4b REDUCED (window 64, ring 64 of max_len 128),
    packed fp4, fp8 KV, paper_fp4: a 40-token prompt at its exact length,
    then 40 batched decode steps, 16 of them past the window (the ring
    wraps): logits and tokens against the reference engine's stages."""
    je, te = _swa_engines(dtype)
    assert not te._can_bucket and te.bucket(40) == 40
    assert te.cache["stack"]["layers"][0]["self"]["pos"].shape == (2, 64)
    prompt = np.random.default_rng(1).integers(0, 512, 40)
    jc1 = je.model.init_cache(1, 128, je.cache_dtype, per_slot=True)
    toks = jnp.asarray(prompt[None].astype(np.int32))
    jl, jc1 = _compiled(_j_prefill(je.model, je.recipe, 40), je.params,
                        toks, jc1)(je.params, toks, jc1)
    tok, c1 = te.prefill(prompt)
    assert tok == int(jnp.argmax(jl[0, -1].astype(jnp.float32)))
    je.insert(jc1, tok, 0)
    te.insert(c1, tok, 0)
    j_decode = _compiled(
        lambda p, t, c: je.model.decode_step(p, t, c, je.recipe),
        je.params, jnp.asarray(je.last_tok[:, None]), je.cache)
    for _ in range(40):
        jl, jcache = j_decode(je.params, jnp.asarray(je.last_tok[:, None]),
                              je.cache)
        je.cache = {**jcache, "length": jnp.where(
            jnp.asarray(je.live), jcache["length"], je.cache["length"])}
        nxt = te.generate_step()
        assert _rel(jl[:1], te.last_logits[:1]) <= TOL[dtype]
        j_next = int(jnp.argmax(jl[0, -1].astype(jnp.float32)))
        assert int(nxt[0]) == j_next
        je.last_tok[0] = j_next
    assert int(te.cache["length"][0]) == 80 == int(je.cache["length"][0])
    assert int(te.cache["stack"]["layers"][0]["self"]["pos"].max()) == 79


def test_ring_guard_raises_where_the_reference_is_inexact():
    """A windowed prefill that would evict keys its own queries need
    raises; the reference computes it and misses its no-cache forward
    (f32 and an f32 cache, window 64, cache max_len 256).  At the ring's size and in
    segments that fit, both are exact; a single-token step never
    raises."""
    jm, jp, tm, tp = _models(SWA, "float32")
    jr, tr = J_RECIPES["bf16"], T_RECIPES["bf16"]
    toks = np.random.default_rng(2).integers(0, 512, (1, 100))

    def j_err(n, segment):
        jc = jm.init_cache(1, 256, jnp.float32)
        for s in range(0, n, segment):
            seg = jnp.asarray(toks[:, s:min(s + segment, n)]
                              .astype(np.int32))
            jl, jc = _compiled(_j_prefill(jm, jr), jp, seg, jc)(jp, seg, jc)
        ref = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}, jr)[0])(
            jp, jnp.asarray(toks[:, :n].astype(np.int32)))[:, -1]
        return float(jnp.abs(jl[:, -1] - ref).max())

    assert j_err(64, 64) < 1e-5 and j_err(64, 16) < 1e-5
    assert j_err(100, 100) > 0.1 and j_err(100, 16) > 0.01
    tt = torch.from_numpy(toks)
    fwd = tm.forward(tp, tt, tr)
    for n, segment in ((64, 64), (64, 16)):
        tl, _ = t_rt.streaming_prefill(tm, tp, tt[:, :n],
                                       tm.init_cache(1, 256, torch.float32), tr, segment)
        torch.testing.assert_close(tl[:, -1], fwd[:, n - 1], rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="ring"):
        tm.prefill(tp, tt, tm.init_cache(1, 256, torch.float32), tr)
    with pytest.raises(ValueError, match="ring"):
        t_rt.streaming_prefill(tm, tp, tt, tm.init_cache(1, 256, torch.float32), tr, 16)
    with pytest.raises(ValueError, match="ring"):
        t_serve.generate(tm, tp, tt, max_new_tokens=2, recipe=tr)
    engine = t_rt.DecodeEngine(tm, tp, n_slots=1, max_len=256,
                               device="cpu")
    with pytest.raises(ValueError, match="ring"):
        engine.prefill(toks[0])
    batcher = t_rt.ContinuousBatcher(tm, tp, n_slots=1, max_len=256,
                                     device="cpu")
    with pytest.raises(ValueError, match="ring"):
        batcher.submit(toks[0], 4)
    # Decode one token at a time far past the ring: exact and allowed.
    cache = tm.init_cache(1, 256, torch.float32)
    logits, cache = tm.prefill(tp, tt[:, :64], cache, tr)
    for t in range(64, 100):
        logits, cache = tm.decode_step(tp, tt[:, t:t + 1], cache, tr)
        torch.testing.assert_close(logits[:, -1], fwd[:, t], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scan", [False, True])
def test_unpacked_weights_bitwise(scan, dtype):
    """``packed=False`` stores the reference's tile-QDQ values bit for
    bit (pos_embed and stacked norm scales included, as the reference
    quantizes them), and equals the packed panel's ``dequantize()`` on
    every packed leaf."""
    jcfg, tcfg = _cfgs("gpt2_125m", "float32", scan_layers=scan)
    jm, tm = j_build(jcfg), t_build(tcfg, "cpu")
    jp = jax.tree.map(lambda a: a.astype(jnp.dtype(dtype)),
                      jm.init(jax.random.PRNGKey(5)))
    want = params_from_jax(jax.tree.map(np.asarray, j_rt.
                           quantize_weights_for_serving(
                               jm, jp, "fp4_e2m1", packed=False)), tcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    got = t_rt.quantize_weights_for_serving(tm, tp, "fp4_e2m1",
                                            packed=False, device="cpu")
    packed = t_rt.quantize_weights_for_serving(tm, tp, "fp4_e2m1",
                                               device="cpu")
    n_packed = 0
    for g, w, p in zip(tree_leaves(got), tree_leaves(want),
                       tree_leaves(packed)):
        assert g.dtype == w.dtype and torch.equal(g, w)
        if isinstance(p, t_rt.PackedTensor):
            n_packed += 1
            assert torch.equal(p.dequantize(), g)
    assert n_packed == (6 if scan else 12)   # 2 layers x 6 linears


def test_serve_fn_cache_reuses_fns():
    """The identities ``tests/test_decode_engine.py`` holds for the
    reference."""
    _, tcfg = _cfgs("tiny", "float32")
    model, model2 = t_build(tcfg, "cpu"), t_build(tcfg, "cpu")
    r = T_RECIPES["bf16"]
    assert t_serve.make_decode_fn(model, r) is t_serve.make_decode_fn(
        model, r)
    assert t_serve.make_prefill_fn(model, r) is t_serve.make_prefill_fn(
        model, r)
    assert t_serve.make_decode_fn(model, r) is not t_serve.make_decode_fn(
        model, r, jit=False)
    assert t_serve.make_decode_fn(model, r) is not t_serve.make_prefill_fn(
        model, r)
    assert t_serve.make_decode_fn(model, r) is not t_serve.make_decode_fn(
        model2, r)


def test_serve_fns_update_the_callers_cache_in_place():
    """``make_prefill_fn`` / ``make_decode_fn`` return the cache they
    were given, its length advanced in place; a windowed model's prefill
    fn is eager (no stage: each length would need its own graph)."""
    _, tcfg = _cfgs("tiny", "float32")
    model = t_build(tcfg, "cpu")
    params, r = model.init(seed=0), T_RECIPES["bf16"]
    cache = model.init_cache(1, 16)
    length = cache["length"]
    _, got = t_serve.make_prefill_fn(model, r)(
        params, torch.arange(5)[None], cache)
    _, got2 = t_serve.make_decode_fn(model, r)(
        params, torch.ones(1, 1, dtype=torch.long), got)
    assert got is cache and got2 is cache and cache["length"] is length
    assert int(length) == 6
    _, scfg = _cfgs(SWA, "float32")
    windowed = t_serve.make_prefill_fn(t_build(scfg, "cpu"), r)
    assert hasattr(t_serve.make_prefill_fn(model, r), "stage")
    assert not hasattr(windowed, "stage")


def test_decode_step_live_mask_freezes_dead_rows():
    """``decode_step(live=...)`` advances only the live rows' lengths,
    in the cache's own length tensor; the logits are those of a step
    without the mask."""
    _, tcfg = _cfgs("tiny", "float32")
    model = t_build(tcfg, "cpu")
    params, r = model.init(seed=0), T_RECIPES["bf16"]
    tok = torch.ones(2, 1, dtype=torch.long)
    out = []
    for live in (None, torch.tensor([True, False])):
        cache = model.init_cache(2, 8, per_slot=True)
        length = cache["length"]
        logits, _ = model.decode_step(params, tok, cache, r, live=live)
        assert cache["length"] is length
        out.append((logits, length.tolist()))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1] == [1, 1] and out[1][1] == [1, 0]


def test_engine_refuses_a_one_slot_cache_a_later_prefill_overwrote():
    """``DecodeEngine.prefill`` returns a cache over the engine's own
    buffers; inserting one that a later prefill has overwritten raises,
    and the latest inserts."""
    _, tcfg = _cfgs("tiny", "float32")
    model = t_build(tcfg, "cpu")
    engine = t_rt.DecodeEngine(model, model.init(seed=0), n_slots=2,
                               max_len=32, device="cpu")
    tok_a, ca = engine.prefill(np.arange(5))
    tok_b, cb = engine.prefill(np.arange(9))
    with pytest.raises(ValueError, match="later prefill"):
        engine.insert(ca, tok_a, 0)
    engine.insert(cb, tok_b, 0)
    engine.insert(cb, tok_b, 1)
    assert engine.cache["length"].tolist() == [9, 9]


def test_generate_jit_matches_eager_and_reference():
    """Greedy ``generate``: jit=True (the captured-stage path; eager on
    CPU tensors) == jit=False == the reference's greedy output, packed
    fp4 weights, fp8 KV, paper_fp4 (f32: the reference's jit adds no
    excess precision there)."""
    jm, jp, tm, tp = _models("tiny", "float32", seed=3,
                             kv_cache_format="fp8_e4m3")
    jq = _j_packed(jm, jp)
    tq = t_rt.quantize_weights_for_serving(tm, tp, "fp4_e2m1",
                                           device="cpu")
    prompts = np.random.default_rng(4).integers(0, 256, (2, 7))
    ref = j_serve.generate(jm, jq, jnp.asarray(prompts.astype(np.int32)),
                           max_new_tokens=8, recipe=J_RECIPES["paper_fp4"])
    outs = [t_serve.generate(tm, tq, torch.from_numpy(prompts),
                             max_new_tokens=8,
                             recipe=T_RECIPES["paper_fp4"], jit=jit)
            for jit in (True, False)]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].tolist() == np.asarray(ref).tolist()


def test_temperature_sampling_is_seeded_and_follows_the_softmax():
    """Sampling with a ``torch.Generator``: one seed gives one output;
    over 40,000 draws from fixed logits each token's frequency is within
    5 standard errors of ``softmax(logits / T)``."""
    _, tcfg = _cfgs("tiny", "float32")
    tm = t_build(tcfg, "cpu")
    tp = tm.init(seed=1)
    prompts = torch.from_numpy(
        np.random.default_rng(5).integers(0, 256, (3, 5)))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return t_serve.generate(tm, tp, prompts, max_new_tokens=6,
                                temperature=0.8, generator=g)
    assert torch.equal(run(7), run(7))
    assert not torch.equal(run(7), run(8))
    logits = torch.from_numpy(
        np.random.default_rng(6).normal(0, 2, 16).astype(np.float32))
    n, temp = 40_000, 0.7
    draws = t_serve.sample_tokens(logits.expand(n, 16), temp,
                                  torch.Generator().manual_seed(0))
    freq = torch.bincount(draws[:, 0], minlength=16).double() / n
    p = torch.softmax(logits.double() / temp, dim=-1)
    assert torch.all((freq - p).abs() <= 5 * (p * (1 - p) / n).sqrt()
                     + 1e-12)
    with pytest.raises(ValueError, match="Generator"):
        t_serve.sample_tokens(logits[None], temp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_true_length_prefill_is_bitwise_the_int_path(dtype):
    """A bucket-padded prefill with ``true_length`` as a 0-d tensor (the
    captured graph's device input) gives the int path's logits and cache
    bit for bit."""
    _, tcfg = _cfgs("gpt2_125m", dtype, linear_impl="pallas",
                    kv_cache_format="fp8_e4m3")
    tm = t_build(tcfg, "cpu")
    tp = t_rt.quantize_weights_for_serving(tm, tm.init(seed=2), "fp4_e2m1",
                                           device="cpu")
    toks = torch.from_numpy(np.random.default_rng(7).integers(0, 512,
                                                              (1, 16)))
    out = []
    for tl in (11, torch.tensor(11, dtype=torch.int32)):
        cache = tm.init_cache(1, 32, per_slot=True)
        out.append(tm.prefill(tp, toks, cache, T_RECIPES["paper_fp4"],
                              true_length=tl))
    (l0, c0), (l1, c1) = out
    assert torch.equal(l0, l1)
    assert c1["length"].dtype == torch.int32 and int(c1["length"][0]) == 11
    for a, b in zip(tree_leaves(c0), tree_leaves(c1)):
        assert torch.equal(a, b)


def test_serve_cli_on_cpu(capsys):
    cli.main(["--arch", "tiny", "--device", "cpu", "--requests", "3",
              "--slots", "2", "--max-new", "4", "--weight-quant",
              "fp4_e2m1"])
    out = capsys.readouterr().out
    assert "weights quantized to fp4_e2m1" in out
    assert "served 3 requests / 12 tokens" in out
    cli.main(["--arch", "h2o-danube-3-4b", "--reduced", "--device", "cpu",
              "--requests", "2", "--max-new", "3"])
    assert "served 2 requests / 6 tokens" in capsys.readouterr().out


def test_windowed_batcher_matches_sequential_generate():
    """Continuous batching over ring caches (h2o-danube-3-4b REDUCED in
    bf16, window 64, 2 slots for 3 requests, packed fp4, fp8 KV,
    paper_fp4): every request decodes past the window and equals the
    sequential ``generate`` token for token.  (In f32 the CPU's matmul
    sums a 2-row product in another order than a 1-row one, and FP4
    rounding carries that into the tokens; bf16 rounds it away, as in
    ``tests/test_torch_decode.py``.)"""
    _, tcfg = _cfgs(SWA, "bfloat16", linear_impl="pallas")
    model = t_build(tcfg, "cpu")
    params = t_rt.quantize_weights_for_serving(model, model.init(seed=4),
                                               "fp4_e2m1", device="cpu")
    batcher = t_rt.ContinuousBatcher(model, params, n_slots=2, max_len=128,
                                     recipe=T_RECIPES["paper_fp4"],
                                     kv_format="fp8_e4m3", device="cpu")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, n) for n in (60, 33, 47)]
    ids = [batcher.submit(p, 40) for p in prompts]
    out = batcher.run()
    for rid, p in zip(ids, prompts):
        assert len(p) + 39 > tcfg.sliding_window
        ref = t_serve.generate(batcher.engine.model, batcher.engine.params,
                               torch.from_numpy(p)[None], max_new_tokens=40,
                               recipe=batcher.engine.recipe)[0, len(p):]
        assert out[rid] == ref.tolist(), rid


def test_stage_runs_eagerly_on_cpu_and_counts_add():
    """A ``GraphedStage`` calls its function as is on CPU tensors
    (nothing captured), and the launch-count helpers a replay uses add a
    delta and take it back exactly."""
    from repro_torch.kernels import build
    from repro_torch.train.graphs import GraphedStage

    def body(w, state, x):
        state["n"] += 1
        return x * w
    stage = GraphedStage(body, "cpu")
    state = {"n": torch.zeros(())}
    y = stage(torch.tensor(3.0), state, torch.ones(2))
    assert torch.equal(y, torch.full((2,), 3.0)) and float(state["n"]) == 1
    assert stage.captures == stage.replays == 0 and not stage.graphs
    before = build.launch_counts()
    delta = {name: {k: 2 for k in counts} for name, counts in before.items()}
    build.add_launch_counts(delta, 3)
    after = build.launch_counts()
    assert all(after[n][k] == before[n][k] + 6 for n in before
               for k in before[n])
    build.add_launch_counts(delta, -3)
    assert build.launch_counts() == before
