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
from torch.utils._python_dispatch import TorchDispatchMode

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


@pytest.fixture(scope="module")
def mamba2():
    """mamba2-780m at full width and depth, packed fp4 weights,
    ``paper_fp4``, and the 8-request draw of ``chip_smoke.py``'s
    ``serve_ssm`` (lengths 16-512, then the prompts, from one seeded
    generator)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("mamba2-780m").replace(linear_impl="pallas")
    model = build_model(cfg)
    params = model.cast_params(quantize_weights_for_serving(
        model, model.init(seed=1, dtype=torch.bfloat16, on_device=True),
        "fp4_e2m1"))
    rng = np.random.default_rng(0)
    lengths = [int(n) for n in rng.integers(16, 513, size=8)]
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lengths]
    return model, params, prompts, RECIPES["paper_fp4"]


def test_mamba2_slots_equal_sequential_generate(mamba2):
    """The 8-request draw through the captured 8-slot
    ``ContinuousBatcher``: each request token for token the sequential
    ``generate`` of it alone (64 new tokens); the message names each
    request's first differing token.  On the card a norm's row mean took
    its launch shape from the number of rows, so a slot among 8 left its
    request's ``generate``; the norms now pad a decode step's rows to one
    count first (``nn.layers.ROW_INVARIANT_ROWS``)."""
    model, params, prompts, recipe = mamba2
    batcher = ContinuousBatcher(model, params, n_slots=8, max_len=1024,
                                recipe=recipe, jit=True)
    ids = [batcher.submit(p, 64) for p in prompts]
    out = batcher.run()
    first = {}
    for i, p in zip(ids, prompts):
        ref = serve.generate(model, params, torch.from_numpy(p)[None],
                             max_new_tokens=64, recipe=recipe)
        ref = ref[0, len(p):].tolist()
        first[i] = next((j for j, (a, b) in enumerate(zip(out[i], ref))
                         if a != b), None)
    assert all(v is None for v in first.values()), \
        f"first token off sequential generate, by request: {first}"


class _Ops(TorchDispatchMode):
    """Every floating-point output of the aten ops run inside, in order
    (an uninitialised ``empty`` left out)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not str(func).startswith("aten.empty"):
            for o in (out if isinstance(out, (tuple, list)) else [out]):
                if isinstance(o, torch.Tensor) and o.is_floating_point():
                    self.ops.append((str(func), o.detach().clone()))
        return out


def _leaves(t):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k])]
    if isinstance(t, list):
        return [x for v in t for x in _leaves(v)]
    return [t]


def test_mamba2_decode_rows_do_not_depend_on_the_batch(mamba2):
    """Three eager decode steps of the 8 slots (each prefilled with its
    request) against slot 3 alone from the same cache: every aten op's
    output row and the cache equal bit for bit (the message names the
    first op whose row differs; the kernels' rows are held by
    ``test_torch_kernels_gpu.py``)."""
    from repro_torch.train.serving_runtime import DecodeEngine
    model, params, prompts, recipe = mamba2
    eng = DecodeEngine(model, params, n_slots=8, max_len=1024,
                       recipe=recipe, jit=False)
    for i, p in enumerate(prompts):
        tok, c1 = eng.prefill(p)
        eng.insert(c1, tok, i)
    r = 3
    one = model.init_cache(1, 1024, torch.bfloat16, per_slot=True)
    for a, b in zip(_leaves(one), _leaves(eng.cache)):
        a.copy_(b[r:r + 1])
    toks = torch.from_numpy(eng.last_tok[:, None]).cuda()
    live = torch.ones(8, dtype=torch.bool, device="cuda")
    p = model.cast_params(eng.params)
    with torch.no_grad():
        for step in range(3):
            rec8, rec1 = _Ops(), _Ops()
            with rec8:
                l8, _ = model.decode_step(p, toks, eng.cache, recipe,
                                          live=live)
            with rec1:
                l1, _ = model.decode_step(p, toks[r:r + 1], one, recipe,
                                          live=live[:1])
            # each batched op against the next op of the same name and
            # row shape among the slot's run's next few (ops with no such
            # partner, as the batched norms' per-row pieces, are passed
            # over; the window keeps the two runs in step)
            ones = [(n, o) for n, o in rec1.ops
                    if o.dim() and o.shape[0] == 1]
            j = 0
            for name, o8 in rec8.ops:
                if not (o8.dim() and o8.shape[0] == 8):
                    continue
                k = next((k for k in range(j, min(j + 8, len(ones)))
                          if ones[k][0] == name
                          and ones[k][1].shape[1:] == o8.shape[1:]), None)
                if k is None:
                    continue
                j = k + 1
                assert torch.equal(o8[r], ones[k][1][0]), \
                    f"step {step}: {name} {tuple(o8.shape)} row {r} differs"
            assert torch.equal(l8[r], l1[0])
            assert all(torch.equal(b[r], a[0]) for a, b in
                       zip(_leaves(one), _leaves(eng.cache)))
            toks = l8[:, -1].float().argmax(-1)[:, None]
