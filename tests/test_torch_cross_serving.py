"""Serving the cross-attention families in the port against the JAX
reference, on the CPU at ``REDUCED`` size: llama-3.2-vision-90b (vlm)
and whisper-base (audio), every ``cross_gate`` at 1.0 on both sides (at
the init's 0 the vlm's cross path would not reach a logit).

* ``generate(extras=...)``: token-exact to the reference's (bf16, run op
  by op), captured and eager alike, on packed fp4 weights with an fp8 KV
  cache; a batch's row equals the same request generated alone.
* Prefill then decode (the cross K/V read from the cache) equals the
  full forward; ``streaming_prefill(extras=...)`` equals the one-shot
  prefill and the reference's.
* Packed serving: the cross and encoder linears packed, payload and
  scales bitwise the reference's; ``cross_gate`` and the norms dense.
* bf16 prefill and decode logits bitwise the reference's (compiled with
  ``xla_allow_excess_precision`` off, as ``tests/test_torch_decode.py``).
* The decode engine refuses both families, whose prefill needs states
  the engine's requests do not carry; the reference's engine cannot
  serve them either.

Bars: tokens equal; logits within max |diff| / max |logit| of 1e-5 in
f32 (summation order); packed panels and bf16 logits bitwise.
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
from repro.train import serve as j_serve  # noqa: E402
from repro.train import serving_runtime as j_rt  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.packed import PackedTensor  # noqa: E402
from repro_torch.core.recipe import RECIPES as T_RECIPES  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.train import serve as t_serve  # noqa: E402
from repro_torch.train import serving_runtime as t_rt  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

VLM, AUDIO = "llama_3_2_vision_90b", "whisper_base"
TOL = 1e-5
NO_EXCESS_PRECISION = {"xla_allow_excess_precision": False}


def _open_gates(tree):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.ones_like(x)
                         if getattr(path[-1], "key", None) == "cross_gate"
                         else x), tree)


def _models(arch, dtype="float32", seed=0, **over):
    """Reference and port models with the same parameters (gates open)."""
    over = {"dtype": dtype, "scan_layers": False, **over}
    jcfg = importlib.import_module(f"repro.configs.{arch}").REDUCED.replace(
        **over)
    tcfg = importlib.import_module(
        f"repro_torch.configs.{arch}").REDUCED.replace(**over)
    jm, tm = j_build(jcfg), t_build(tcfg, "cpu")
    jp = _open_gates(jm.init(jax.random.PRNGKey(seed)))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp), tcfg)


def _extras(cfg, b, seed=7):
    key, n = (("vision", cfg.n_patches) if cfg.family == "vlm"
              else ("frames", cfg.n_frames))
    st = np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model)).astype(np.float32)
    return {key: jnp.asarray(st)}, {key: torch.from_numpy(st)}


def _packed(jm, jp, tm, tp):
    """Packed fp4 weights on both sides (the reference's op by op: under
    ``jit`` XLA computes a scale's ``amax / 6`` an ulp apart now and
    then)."""
    jq = j_rt.quantize_weights_for_serving(jm, jp, "fp4_e2m1")
    return jq, t_rt.quantize_weights_for_serving(tm, tp, "fp4_e2m1",
                                                 device="cpu")


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


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_generate_with_extras_matches_reference(arch):
    """Greedy ``generate`` with the states in ``extras``, bf16 (the
    serving dtype), packed fp4, fp8 KV, paper_fp4, "pallas": jit=True
    (eager on CPU tensors) == jit=False == the reference's greedy output
    run op by op (no excess precision: its bf16 logits are the port's bit
    for bit, as in ``test_bf16_prefill_and_decode_logits_bitwise``), and
    row 1 of the batch == the same request alone.  (In f32 the two sides'
    K/V projections differ in their last bits by summation order, and on
    whisper one fp8 KV code of layer 0 flips a grid step, which moves its
    prefill logits by 12% of max|logit| at this size.)"""
    jm, jp, tm, tp = _models(arch, "bfloat16", kv_cache_format="fp8_e4m3",
                             linear_impl="pallas")
    jq, tq = _packed(jm, jp, tm, tp)
    prompts = np.random.default_rng(4).integers(0, 512, (2, 7))
    jx, tx = _extras(tm.cfg, 2)
    recipe = "paper_fp4"
    ref = j_serve.generate(jm, jq, jnp.asarray(prompts.astype(np.int32)),
                           max_new_tokens=4, recipe=J_RECIPES[recipe],
                           extras=jx, jit=False)
    outs = [t_serve.generate(tm, tq, torch.from_numpy(prompts),
                             max_new_tokens=4, recipe=T_RECIPES[recipe],
                             extras=tx, jit=jit) for jit in (True, False)]
    assert torch.equal(outs[0], outs[1])
    assert outs[0].tolist() == np.asarray(ref).tolist()
    alone = t_serve.generate(tm, tq, torch.from_numpy(prompts[1:]),
                             max_new_tokens=4, recipe=T_RECIPES[recipe],
                             extras={k: v[1:] for k, v in tx.items()})
    assert torch.equal(alone[0], outs[0][1])


def test_prefill_decode_and_streaming_prefill_with_vision():
    """vlm, f32, bf16 recipe, f32 caches: an 18-token prefill then 5
    decode steps (the cross K/V read from the cache) give the full
    forward's logits at every position; ``streaming_prefill`` in
    segments of 8 (the vision projected again each segment) gives the
    one-shot prefill's logits and cross cache and the reference's
    streaming prefill's logits.  The cross cache holds exactly
    ``n_patches`` positions."""
    jm, jp, tm, tp = _models(VLM)
    r_j, r_t = J_RECIPES["bf16"], T_RECIPES["bf16"]
    toks = np.random.default_rng(2).integers(0, 512, (2, 24))
    jx, tx = _extras(tm.cfg, 2)
    tt = torch.from_numpy(toks)
    full = tm.forward(tp, tt, r_t, extras=tx)
    cache = tm.init_cache(2, 28, torch.float32)
    cross = cache["stack"]["layers"][3]["cross"]
    assert tuple(cross["k"].shape) == (2, tm.cfg.n_patches,
                                       tm.cfg.n_kv_heads,
                                       tm.cfg.resolved_head_dim)
    lg, _ = tm.prefill(tp, tt[:, :18], cache, r_t, extras=tx)
    got = [lg[:, 0]]
    for t in range(18, 23):
        lg, _ = tm.decode_step(tp, tt[:, t:t + 1], cache, r_t)
        got.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(got, 1), full[:, 17:23],
                               rtol=0, atol=TOL * float(full.abs().max()))
    sl, sc = t_rt.streaming_prefill(tm, tp, tt, tm.init_cache(
        2, 28, torch.float32), r_t, segment=8, extras=tx)
    ol, oc = tm.prefill(tp, tt, tm.init_cache(2, 28, torch.float32), r_t,
                        extras=tx)
    torch.testing.assert_close(sl, ol, rtol=1e-5, atol=1e-6)
    for n in ("k", "v"):
        assert torch.equal(sc["stack"]["layers"][3]["cross"][n],
                           oc["stack"]["layers"][3]["cross"][n])
    jl, _ = j_rt.streaming_prefill(
        jm, jp, jnp.asarray(toks.astype(np.int32)),
        jm.init_cache(2, 28, jnp.float32), r_j, segment=8, extras=jx)
    assert _rel(jl, sl) <= TOL


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_packed_cross_and_encoder_panels_bitwise(arch):
    """The cross sublayer's and the encoder's linears pack, payload and
    scales bitwise the reference's; ``cross_gate`` (f32), norms, the
    embedding and pos_embed stay dense and unchanged."""
    jm, jp, tm, tp = _models(arch)
    jq, tq = _packed(jm, jp, tm, tp)
    jflat = dict(_named(jax.tree.map(lambda x: x, jq, is_leaf=lambda x:
                                     isinstance(x, JPacked))))
    orig = dict(_named(tp))
    packed_paths = []
    for path, leaf in _named(tq):
        ref = jflat[path]
        if isinstance(leaf, PackedTensor):
            packed_paths.append(path)
            assert isinstance(ref, JPacked), path
            assert np.array_equal(leaf.payload.numpy(),
                                  np.asarray(ref.payload)), path
            assert np.array_equal(leaf.scale.numpy(),
                                  np.asarray(ref.scale)), path
        else:
            assert not isinstance(ref, JPacked), path
            assert torch.equal(leaf, orig[path]), path
    if arch == VLM:
        assert {p for p in packed_paths if "/cross/" in p} == {
            f"/stack/layers/3/cross/{w}" for w in ("wq", "wk", "wv", "wo")}
        gate = tq["stack"]["layers"][3]["cross_gate"]
        assert gate.dtype == torch.float32 and float(gate) == 1.0
    else:
        enc = [p for p in packed_paths if p.startswith("/encoder/")]
        assert len(enc) == 2 * 6          # 2 layers x wq, wk, wv, wo, up, down


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_bf16_prefill_and_decode_logits_bitwise(arch):
    """bf16, packed fp4, paper_fp4, "pallas": the prefill's logits (the
    states in ``extras``) and 3 decode steps' (the cross K/V from the
    cache) bit for bit the reference's, compiled without excess
    precision."""
    jm, jp, tm, tp = _models(arch, "bfloat16", linear_impl="pallas")
    jq, tq = _packed(jm, jp, tm, tp)
    tq = tm.cast_params(tq)
    r_j, r_t = J_RECIPES["paper_fp4"], T_RECIPES["paper_fp4"]
    toks = np.random.default_rng(3).integers(0, 512, (2, 12)).astype(
        np.int32)
    jx, tx = _extras(tm.cfg, 2)
    jx = {k: v.astype(jnp.bfloat16) for k, v in jx.items()}
    tx = {k: v.to(torch.bfloat16) for k, v in tx.items()}
    jc = jm.init_cache(2, 16)
    batch = {"tokens": jnp.asarray(toks), **jx}
    jl, jc = _compiled(lambda p, b, c: jm.prefill(p, b, c, r_j),
                       jq, batch, jc)(jq, batch, jc)
    tc = tm.init_cache(2, 16)
    tl, _ = tm.prefill(tq, torch.from_numpy(toks), tc, r_t, extras=tx)
    assert _rel(jl, tl) == 0.0
    step = _compiled(lambda p, t, c: jm.decode_step(p, t, c, r_j), jq,
                     jnp.zeros((2, 1), jnp.int32), jc)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1].astype(jnp.float32), -1))
        nxt = nxt.astype(np.int32)[:, None]
        jl, jc = step(jq, jnp.asarray(nxt), jc)
        tl, _ = tm.decode_step(tq, torch.from_numpy(nxt), tc, r_t)
        assert _rel(jl, tl) == 0.0


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_decode_engine_refuses_cross_families(arch):
    """``DecodeEngine`` and ``ContinuousBatcher`` raise for vlm and audio
    at construction.  The reference's engine prefills with the tokens
    alone, so its prefill fails on a cross family for want of states."""
    jm, jp, tm, tp = _models(arch)
    for make in (t_rt.DecodeEngine, t_rt.ContinuousBatcher):
        with pytest.raises(NotImplementedError, match=tm.cfg.family):
            make(tm, tp, n_slots=2, max_len=32, device="cpu")
    je = j_rt.DecodeEngine(jm, jp, n_slots=2, max_len=32, jit=False)
    with pytest.raises(KeyError):
        je.prefill(np.arange(5))
