"""The serving stages captured as CUDA graphs (``jit=True``) against the
same stages run eagerly, on the card.  Marked ``gpu``; each test skips
without a CUDA device.  No JAX here: the card's machine has none.  Run on
the card with

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        -m gpu tests/test_torch_graphs_gpu.py

Setup: ``tiny`` (2 layers, GQA) with packed fp4 weights, fp8 KV,
``paper_fp4`` and ``linear_impl="pallas"``, so every replay runs the
GEMM kernels.  Bars: tokens equal (a graph replays the eager call's
kernels on the same inputs); a second ``generate`` with the same shapes
captures nothing; every replay adds its capture's launch counts; a
serving fn keeps at most ``MAX_GRAPHS`` graphs.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.recipe import RECIPES
from repro_torch.kernels import qmm_stream, quantize_rows, tiled_mm
from repro_torch.models import build_model
from repro_torch.train import serve
from repro_torch.train.serving_runtime import (ContinuousBatcher,
                                               quantize_weights_for_serving)

pytestmark = pytest.mark.gpu
GEMMS = (qmm_stream.KERNEL, quantize_rows.KERNEL, tiled_mm.KERNEL)


@pytest.fixture
def served():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("tiny").replace(linear_impl="pallas",
                                     kv_cache_format="fp8_e4m3")
    model = build_model(cfg)
    params = model.cast_params(quantize_weights_for_serving(
        model, model.init(seed=0), "fp4_e2m1"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(3, 40, size=5)]
    return model, params, prompts


def _serve(model, params, prompts, jit):
    batcher = ContinuousBatcher(model, params, n_slots=3, max_len=64,
                                recipe=RECIPES["paper_fp4"],
                                kv_format="fp8_e4m3", jit=jit)
    ids = [batcher.submit(p, 9) for p in prompts]
    out = batcher.run()
    return [out[i] for i in ids], batcher.engine


def test_captured_engine_equals_eager(served):
    model, params, prompts = served
    eager, _ = _serve(model, params, prompts, jit=False)
    for k in GEMMS:
        k.reset()
    got, engine = _serve(model, params, prompts, jit=True)
    assert got == eager
    stages = engine.stages
    assert stages["generate"].captures == 1
    assert stages["generate"].replays >= 8
    assert stages["insert"].captures == 1
    assert stages["prefill"].captures == len(
        {engine.bucket(len(p)) for p in prompts})
    assert all(k.launches > 0 for k in GEMMS), [k.counts() for k in GEMMS]


def test_generate_captures_once_and_counts_replays(served):
    model, params, prompts = served
    prompt = torch.from_numpy(prompts[0])[None]
    recipe = RECIPES["paper_fp4"]
    eager = serve.generate(model, params, prompt, max_new_tokens=6,
                           recipe=recipe, jit=False)
    first = serve.generate(model, params, prompt, max_new_tokens=6,
                           recipe=recipe)
    assert torch.equal(first, eager)
    prefill = serve.make_prefill_fn(model, recipe).stage
    decode = serve.make_decode_fn(model, recipe).stage
    captures = (prefill.captures, decode.captures)
    assert captures == (1, 1)
    graph = next(iter(decode.graphs.values()))
    per_replay = {k.name: graph.launches[k.name]["launches"] for k in GEMMS}
    assert all(n > 0 for n in per_replay.values()), per_replay
    before = {k.name: k.launches for k in GEMMS}
    again = serve.generate(model, params, prompt, max_new_tokens=6,
                           recipe=recipe)
    assert torch.equal(again, eager)
    assert (prefill.captures, decode.captures) == captures
    pre = next(iter(prefill.graphs.values()))
    for k in GEMMS:
        want = (pre.launches[k.name]["launches"]
                + 5 * per_replay[k.name])
        assert k.launches - before[k.name] == want, k.name


def test_serve_fn_keeps_at_most_max_graphs(served):
    """A serving fn captures a graph per cache it is given, keeps the
    ``MAX_GRAPHS`` most recently used, and each call updates the cache
    it was given, as the eager step does."""
    model, params, prompts = served
    recipe = RECIPES["paper_fp4"]
    decode = serve.make_decode_fn(model, recipe)
    tok = torch.from_numpy(prompts[0][:1])[None].cuda()
    eager, _ = serve.make_decode_fn(model, recipe, jit=False)(
        params, tok, model.init_cache(1, 16))
    before = decode.stage.captures
    for _ in range(serve.MAX_GRAPHS + 2):
        cache = model.init_cache(1, 16)
        logits, got = decode(params, tok, cache)
        assert got is cache and int(cache["length"]) == 1
        assert torch.equal(logits, eager)
    assert decode.stage.captures - before == serve.MAX_GRAPHS + 2
    assert len(decode.stage.graphs) == serve.MAX_GRAPHS


def test_cached_attention_rows_are_batch_invariant(served):
    """A decode step's row in a batch of 4 equals the same row decoded
    alone, bit for bit (attention over a cache runs row by row; cuBLAS's
    batched products are not invariant to the batch count), at
    h2o-danube-3-4b's attention widths over a full 4096-position ring."""
    cfg = get_config("h2o-danube-3-4b").replace(n_layers=1,
                                                 vocab_size=512)
    model = build_model(cfg)
    params = model.cast_params(model.init(seed=1, on_device=True))
    recipe = RECIPES["bf16"]
    prompt = torch.randint(0, 512, (1, 4000), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(2))
    one = model.init_cache(1, 4200)
    model.prefill(params, prompt, one, recipe)
    four = model.init_cache(4, 4200)
    model.prefill(params, prompt.expand(4, -1).contiguous(), four, recipe)
    tok = prompt[:, :1]
    for _ in range(3):
        l1, one = model.decode_step(params, tok, one, recipe)
        l4, four = model.decode_step(params, tok.expand(4, 1).contiguous(),
                                     four, recipe)
        assert all(torch.equal(l4[i], l1[0]) for i in range(4))
        tok = torch.argmax(l1[:, -1].float(), -1)[:, None]


def test_capture_refuses_host_syncs(served):
    """A stage body that reads a device value on the host raises at
    capture (``set_sync_debug_mode("error")``); nothing runs eagerly in
    its place."""
    from repro_torch.train.graphs import GraphedStage

    def body(_w, _s, x):
        return x * int(x.sum())
    stage = GraphedStage(body, "sync")
    with pytest.raises(RuntimeError):
        stage(None, None, torch.ones(4, device="cuda"))
    assert stage.replays == 0
