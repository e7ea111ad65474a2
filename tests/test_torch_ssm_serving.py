"""The port's SSM family (mamba2-780m) and hybrid stack (jamba-1.5-
large-398b) on the serving path, and the cached attention's independence
of the cache's length, on the CPU at ``REDUCED`` size, against the JAX
reference where it has the same behaviour.

* Packed serving: the in-projections and out_proj packed (payload and
  scales bitwise the reference's, ``in_dt`` N below one tile among
  them), the conv weights and the f32 leaves dense and unchanged.
* The engine: exact-length prefill (no buckets), its slots equal to the
  sequential ``generate`` token for token (mamba2, and jamba's hybrid
  decode step of attention KV, mamba state and MoE); its prefill and
  decode logits against the reference engine's stages.
* Prefill then decode equals the full forward; ``streaming_prefill``
  over segments equals the one-shot prefill and the reference's.
* Reference property 2 (``repro/models/ssm.py:314-322``): a prefill of
  fewer than ``d_conv - 1`` tokens onto a non-empty cache zero-pads the
  conv history in the reference, whose next decode step then parts from
  the full forward; the port keeps the history.
* The cached attention's chunks are as wide whatever the cache's length:
  a decode step over a ``max_len`` 2048 cache gives the bits of one over
  a prompt + 64 cache.

Bars as ``tests/test_torch_serving.py``'s: max |logit difference| / max
|logit| within 1e-5 in f32 and 1e-2 in bf16; tokens equal; packed panels
bitwise.
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.packed import PackedTensor as JPacked  # noqa: E402
from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train import serving_runtime as j_rt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.packed import PackedTensor  # noqa: E402
from repro_torch.core.recipe import RECIPES as T_RECIPES  # noqa: E402
from repro_torch.launch import serve as cli  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from repro_torch.train import serve as t_serve  # noqa: E402
from repro_torch.train import serving_runtime as t_rt  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}
MAMBA, JAMBA = "mamba2_780m", "jamba_1_5_large_398b"


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


def _named(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{path}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{path}/{i}")
    else:
        yield path, tree


def test_packed_serving_leaves_conv_and_f32_leaves_dense():
    """mamba2 ``REDUCED``: the five in-projections and out_proj pack
    (payload and scales bitwise the reference's; ``in_dt`` is 64 x 8, one
    partial tile), the conv weights, ``dt_bias``, ``a_log``, ``d_skip``,
    norms and the embedding stay dense and unchanged."""
    jm, jp, tm, tp = _models(MAMBA, "float32")
    jq = j_rt.quantize_weights_for_serving(jm, jp, "fp4_e2m1")
    tq = t_rt.quantize_weights_for_serving(tm, tp, "fp4_e2m1", device="cpu")
    jflat = dict(_named(jax.tree.map(lambda x: x, jq, is_leaf=lambda x:
                                     isinstance(x, JPacked))))
    packed = {"in_z", "in_x", "in_b", "in_c", "in_dt", "out_proj"}
    dense = {"conv_wx", "conv_wb", "conv_wc", "dt_bias", "a_log", "d_skip",
             "embed", "scale", "norm_scale", "conv_bx", "conv_bb",
             "conv_bc"}
    orig = dict(_named(tp))
    seen = set()
    for path, leaf in _named(tq):
        name = path.rsplit("/", 1)[-1]
        seen.add(name)
        if name in packed:
            assert isinstance(leaf, PackedTensor), path
            ref = jflat[path]
            assert isinstance(ref, JPacked), path
            assert np.array_equal(leaf.payload.numpy(),
                                  np.asarray(ref.payload)), path
            assert np.array_equal(leaf.scale.numpy(),
                                  np.asarray(ref.scale)), path
        else:
            assert name in dense, path
            assert not isinstance(leaf, PackedTensor), path
            assert torch.equal(leaf, orig[path]), path
    assert packed | {"conv_wx", "dt_bias", "a_log", "d_skip"} <= seen


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_prefill_then_decode_equals_full_forward(arch):
    """f32, bf16 recipe: a 18-token prefill then 6 decode steps give the
    full forward's logits at every position (mamba2; jamba's attention,
    mamba and MoE layers: its capacity raised so that no token drops,
    as routing groups differ between a prefill and a forward)."""
    _, tcfg = _cfgs(arch, "float32")
    if tcfg.moe is not None:
        tcfg = tcfg.replace(moe=tcfg.moe.__class__(
            **{**tcfg.moe.__dict__, "capacity_factor": 16.0}))
    model = t_build(tcfg, "cpu")
    params = model.init(seed=1)
    r = T_RECIPES["bf16"]
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 24)))
    full = model.forward(params, toks, r)
    cache = model.init_cache(2, 28, torch.float32)
    lg, _ = model.prefill(params, toks[:, :18], cache, r)
    got = [lg[:, 0]]
    for t in range(18, 23):
        lg, _ = model.decode_step(params, toks[:, t:t + 1], cache, r)
        got.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(got, 1), full[:, 17:23],
                               rtol=0, atol=1e-4 * float(full.abs().max()))


def test_streaming_prefill_matches_one_shot_and_reference():
    """mamba2 ``REDUCED``, f32 with an f32 cache: segments of 16 over 40
    tokens (the last partial) carry the conv history and the state
    across, giving the one-shot prefill's logits and cache and the
    reference's.  (A bf16 cache, the engine's, rounds the conv history
    at each segment's end, which the one-shot prefill does not.)"""
    jm, jp, tm, tp = _models(MAMBA, "float32")
    r_j, r_t = J_RECIPES["bf16"], T_RECIPES["bf16"]
    toks = np.random.default_rng(0).integers(0, 512, (2, 40))
    jc = jm.init_cache(2, 48, jnp.float32)
    f32 = torch.float32

    def j_prefill(p, t, c):
        return jm.prefill(p, {"tokens": t}, c, r_j)
    for s in range(0, 40, 16):
        seg = jnp.asarray(toks[:, s:s + 16].astype(np.int32))
        jl, jc = _compiled(j_prefill, jp, seg, jc)(jp, seg, jc)
    tt = torch.from_numpy(toks)
    tl, tc = t_rt.streaming_prefill(tm, tp, tt, tm.init_cache(2, 48, f32),
                                    r_t, segment=16)
    ol, oc = tm.prefill(tp, tt, tm.init_cache(2, 48, f32), r_t)
    assert _rel(jl, tl) <= TOL["float32"]
    torch.testing.assert_close(tl, ol, rtol=1e-5, atol=1e-6)
    for a, b in zip(tree_leaves(tc), tree_leaves(oc)):
        torch.testing.assert_close(a.float(), b.float(), rtol=1e-4,
                                   atol=1e-5)
    state = tc["stack"]["layers"][1]["self"]["state"]
    want = np.asarray(jc["stack"]["layers"][1]["self"]["state"])
    assert float(np.abs(state.numpy() - want).max()
                 / np.abs(want).max()) <= TOL["float32"]


def test_short_prefill_onto_a_cache_keeps_the_conv_history():
    """Reference property 2: 20 tokens prefilled, then a 2-token prefill
    (fewer than d_conv - 1 = 3), then one decode step.  The reference
    zero-pads the conv history there, and its decode logits part from its
    own full forward; the port takes the history from the cache, and its
    equal the full forward's within the f32 bar."""
    jm, jp, tm, tp = _models(MAMBA, "float32")
    r_j, r_t = J_RECIPES["bf16"], T_RECIPES["bf16"]
    toks = np.random.default_rng(3).integers(0, 512, (1, 23)).astype(
        np.int32)
    jfull = jm.forward(jp, {"tokens": jnp.asarray(toks)}, r_j)[0]
    tfull = tm.forward(tp, torch.from_numpy(toks), r_t)

    def j_prefill(p, t, c):
        return jm.prefill(p, {"tokens": t}, c, r_j)
    jc = jm.init_cache(1, 32, jnp.float32)
    for a, b in ((0, 20), (20, 22)):
        seg = jnp.asarray(toks[:, a:b])
        _, jc = _compiled(j_prefill, jp, seg, jc)(jp, seg, jc)
    jl, _ = jm.decode_step(jp, jnp.asarray(toks[:, 22:23]), jc, r_j)
    tc = tm.init_cache(1, 32, torch.float32)
    for a, b in ((0, 20), (20, 22)):
        tm.prefill(tp, torch.from_numpy(toks[:, a:b]), tc, r_t)
    tl, _ = tm.decode_step(tp, torch.from_numpy(toks[:, 22:23]), tc, r_t)
    assert _rel(jfull[:, 22:23], tl) <= TOL["float32"]
    ref_err = float(np.abs(np.asarray(jl) - np.asarray(jfull[:, 22:23]))
                    .max() / np.abs(np.asarray(jfull)).max())
    assert ref_err > 100 * TOL["float32"]
    assert _rel(jfull, tfull) <= TOL["float32"]


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_engine_prefills_at_exact_length_and_equals_generate(arch):
    """bf16, packed fp4, fp8 KV, paper_fp4, "pallas": the engine prefills
    at the prompt's exact length and its slots (2 slots for 3 requests)
    equal the sequential ``generate`` token for token.  jamba's decode
    step holds attention KV, mamba state and MoE; with 2 slots its
    capacity (2 a expert) drops no decode token.  (In f32 the CPU's
    matmul sums a 2-row product in another order than a 1-row one and
    FP4 rounding carries that into the tokens; bf16 rounds it away, as
    in ``tests/test_torch_decode.py``.)"""
    _, tcfg = _cfgs(arch, "bfloat16", linear_impl="pallas")
    model = t_build(tcfg, "cpu")
    params = t_rt.quantize_weights_for_serving(model, model.init(seed=4),
                                               "fp4_e2m1", device="cpu")
    batcher = t_rt.ContinuousBatcher(model, params, n_slots=2, max_len=64,
                                     recipe=T_RECIPES["paper_fp4"],
                                     kv_format="fp8_e4m3", device="cpu")
    engine = batcher.engine
    assert not engine._can_bucket and engine.bucket(19) == 19
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 512, n) for n in (19, 5, 33)]
    ids = [batcher.submit(p, 12) for p in prompts]
    out = batcher.run()
    for rid, p in zip(ids, prompts):
        ref = t_serve.generate(engine.model, engine.params,
                               torch.from_numpy(p)[None], max_new_tokens=12,
                               recipe=engine.recipe)[0, len(p):]
        assert out[rid] == ref.tolist(), rid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_logits_match_reference(dtype):
    """mamba2 ``REDUCED``, packed fp4, paper_fp4, "pallas": a 21-token
    exact-length prefill and 4 batched decode steps of slot 0 against the
    reference engine's stages (logits within the bar, tokens equal)."""
    jm, jp, tm, tp = _models(MAMBA, dtype, linear_impl="pallas")
    jq = jax.jit(lambda p: j_rt.quantize_weights_for_serving(
        jm, p, "fp4_e2m1"))(jp)
    je = j_rt.DecodeEngine(jm, jq, n_slots=2, max_len=32,
                           recipe=J_RECIPES["paper_fp4"])
    te = t_rt.DecodeEngine(tm, t_rt.quantize_weights_for_serving(
        tm, tp, "fp4_e2m1", device="cpu"), n_slots=2, max_len=32,
        recipe=T_RECIPES["paper_fp4"], device="cpu")
    prompt = np.random.default_rng(1).integers(0, 512, 21)
    jc1 = je.model.init_cache(1, 32, je.cache_dtype, per_slot=True)
    toks = jnp.asarray(prompt[None].astype(np.int32))

    def j_prefill(p, t, c):
        return je.model.prefill(p, {"tokens": t}, c, je.recipe)
    jl, jc1 = _compiled(j_prefill, je.params, toks, jc1)(je.params, toks,
                                                          jc1)
    tok, c1 = te.prefill(prompt)
    assert tok == int(jnp.argmax(jl[0, -1].astype(jnp.float32)))
    je.insert(jc1, tok, 0)
    te.insert(c1, tok, 0)
    j_decode = _compiled(
        lambda p, t, c: je.model.decode_step(p, t, c, je.recipe),
        je.params, jnp.asarray(je.last_tok[:, None]), je.cache)
    for _ in range(4):
        jl, jcache = j_decode(je.params, jnp.asarray(je.last_tok[:, None]),
                              je.cache)
        je.cache = {**jcache, "length": jnp.where(
            jnp.asarray(je.live), jcache["length"], je.cache["length"])}
        nxt = te.generate_step()
        assert _rel(jl[:1], te.last_logits[:1]) <= TOL[dtype]
        j_next = int(jnp.argmax(jl[0, -1].astype(jnp.float32)))
        assert int(nxt[0]) == j_next
        je.last_tok[0] = j_next
    assert te.cache["stack"]["layers"][0]["self"]["state"].shape == \
        (2, 8, 16, 16)


def test_cached_attention_bits_do_not_depend_on_the_cache_length():
    """``tiny`` with ``attention_chunk`` 32, f32: a 40-token prefill and
    63 decode steps over a cache of max_len 256 (8 chunks) give the bits
    of the same calls over a cache of 40 + 64 positions (allocated as 4
    whole chunks, the last 24 slots unwritten).  With a cache of exactly
    max_len and chunks of min(chunk, cache length), as the reference
    takes them, the short cache's last chunk is 8 keys wide, and once the
    keys reach it the logits part in their last bits (1.4e-6 on a CPU)."""
    cfg = importlib.import_module("repro_torch.configs.tiny").CONFIG
    model = t_build(cfg.replace(dtype="float32", attention_chunk=32), "cpu")
    params = model.init(seed=0)
    r = T_RECIPES["bf16"]
    prompt, new = 40, 64
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, prompt + new)))
    out = []
    for max_len in (256, prompt + new):
        cache = model.init_cache(1, max_len, torch.float32)
        assert cache["stack"]["layers"][0]["self"]["pos"].shape == (
            -(-max_len // 32) * 32,)
        lg, _ = model.prefill(params, toks[:, :prompt], cache, r)
        logits = [lg]
        for t in range(prompt, prompt + new - 1):
            lg, _ = model.decode_step(params, toks[:, t:t + 1], cache, r)
            logits.append(lg)
        out.append(torch.cat(logits, 1))
    assert torch.equal(out[0], out[1])


def test_serve_cli_runs_mamba_on_cpu(capsys):
    """``launch/serve.py --arch mamba2-780m`` (``REDUCED``, packed fp4)
    serves every request on the CPU."""
    cli.main(["--arch", "mamba2-780m", "--reduced", "--device", "cpu",
              "--requests", "3", "--slots", "2", "--max-new", "4",
              "--weight-quant", "fp4_e2m1"])
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out
