"""The GEMM kernels at every tiling they are built for, and the tuning
sweep, on the card.  Marked ``gpu``; each test skips without a CUDA
device.  No JAX here.  Run on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        -m gpu tests/test_torch_autotune_gpu.py

Bars: at every built (bm, bn), every trans pair, every pair of stream
modes (pass, block, tile), with and without SR and the stats epilogue,
at ragged shapes and in one batched (expert) call, ``qmm_stream`` and
``tiled_mm`` outputs and stats bitwise equal to the 128 x 128 tiling's
(no tiling changes a value: every output element is summed by the same
wgmma sequence and the QDQ is keyed by global coordinates), the stream
pipeline bitwise equal to the two-pass one at that tiling, and both
within ``tests/test_torch_kernels_gpu.py``'s bars of the plain versions.
"""
import pytest
import torch

from repro_torch.kernels import autotune as ta
from repro_torch.kernels import fp4_matmul as fm
from repro_torch.kernels import qmm_stream as qs
from repro_torch.kernels import tiled_mm as tm
from repro_torch.kernels.build import TILINGS
from test_torch_kernels_gpu import (SEED, TRANS, _assert_gemm_close,
                                    _assert_stats, _bits, _stored)
from test_torch_kernels_gpu import cuda  # noqa: F401  (the card fixture)

pytestmark = pytest.mark.gpu

TILES = [t[:2] for t in TILINGS]
# M 130 (one 256-row block, ragged), K 3392 (llama-1b's d_ff), N 960
# (h2o's wk); and several blocks both ways, ragged at 256.
SHAPES = ((130, 3392, 960), (600, 384, 640))
MODES = ("pass", "block", "tile")


def _stream(a, b, tiles, extra, **kw):
    """``qmm_stream`` at a tiling, with SR on both quantized operands and
    the stats epilogue when ``extra``."""
    if extra:
        kw.update(a_sr=True, b_sr=True, seed_a=SEED, seed_b=7,
                  collect_stats=True)
    out = qs.qmm_stream(a, b, bm=tiles[0], bn=tiles[1], **kw)
    return out if extra else (out, (None, None))


@pytest.mark.parametrize("extra", [False, True])
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("b_mode", MODES)
@pytest.mark.parametrize("a_mode", MODES)
@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("tiles", TILES)
def test_qmm_stream_tiling_bitwise(cuda, tiles, m, k, n, a_mode, b_mode,
                                   trans_a, trans_b, extra):
    a = _stored((m, k), trans_a, torch.bfloat16, 31)
    b = _stored((k, n), trans_b, torch.bfloat16, 32, 0.05)
    kw = dict(a_mode=a_mode, b_mode=b_mode, a_fmt="fp4_e2m1",
              b_fmt="fp8_e4m3", trans_a=trans_a, trans_b=trans_b)
    tc = qs.KERNEL.tile_launches.get(tiles, 0)
    y, st = _stream(a, b, tiles, extra, **kw)
    assert qs.KERNEL.tile_launches[tiles] == tc + 1
    y128, st128 = _stream(a, b, (128, 128), extra, **kw)
    # the two-pass pipeline at the same tiling
    two = fm.fused_qmm(a, b, pipeline="two_pass", bm=tiles[0], bn=tiles[1],
                       **({"a_sr": True, "b_sr": True, "seed_a": SEED,
                           "seed_b": 7, "collect_stats": True}
                          if extra else {}), **kw)
    y2, st2 = two if extra else (two, (None, None))
    ref = qs.qmm_stream_plain(
        a, b, **({"seed_a": SEED if a_mode != "pass" else None,
                  "seed_b": 7 if b_mode != "pass" else None,
                  "collect_stats": True} if extra else {}), **kw)
    y_ref, st_ref = ref if extra else (ref, (None, None))
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(y128))
    assert torch.equal(_bits(y), _bits(y2))
    _assert_gemm_close(y, y_ref)
    for s, s128, s2, r in zip(st, st128, st2, st_ref):
        assert (s is None) == (s128 is None) == (s2 is None) == (r is None)
        if s is not None:
            assert torch.equal(s, s128) and torch.equal(s, s2)
            _assert_stats(s, r)


@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("m,k,n", SHAPES + ((256, 256, 256),))
@pytest.mark.parametrize("tiles", TILES)
def test_tiled_mm_tiling_bitwise(cuda, tiles, m, k, n, trans_a, trans_b):
    a = _stored((m, k), trans_a, torch.bfloat16, 3)
    b = _stored((k, n), trans_b, torch.bfloat16, 4)
    kw = dict(trans_a=trans_a, trans_b=trans_b)
    y = tm.tiled_mm(a, b, bm=tiles[0], bn=tiles[1], **kw)
    y128 = tm.tiled_mm(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(y128))
    _assert_gemm_close(y, tm.tiled_mm_plain(a, b, **kw))


@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("tiles", TILES)
def test_batched_tiling_bitwise(cuda, tiles, trans_a, trans_b):
    """One batched launch of 4 pairs (the experts) at each tiling: both
    kernels bitwise equal to 128 x 128 and to one launch per pair."""
    e, m, k, n = 4, 300, 384, 320
    a = torch.stack([_stored((m, k), trans_a, torch.bfloat16, 50 + i)
                     for i in range(e)])
    b = torch.stack([_stored((k, n), trans_b, torch.bfloat16, 60 + i, 0.05)
                     for i in range(e)])
    kw = dict(trans_a=trans_a, trans_b=trans_b)
    qkw = dict(a_mode="block", b_mode="tile", a_fmt="fp4_e2m1",
               b_fmt="fp4_e2m1", **kw)
    for fn, extra in ((qs.qmm_stream, qkw), (tm.tiled_mm, kw)):
        y = fn(a, b, bm=tiles[0], bn=tiles[1], **extra)
        y128 = fn(a, b, **extra)
        one = torch.stack([fn(x, w, bm=tiles[0], bn=tiles[1], **extra)
                           for x, w in zip(a, b)])
        torch.cuda.synchronize()
        assert torch.equal(_bits(y), _bits(y128))
        assert torch.equal(_bits(y), _bits(one))


@pytest.mark.parametrize("tiles", TILES)
def test_fused_qmm_table_hit_on_the_card(cuda, tiles):
    """A table entry reaches the tensor-core launch (the tile counter
    moves) and gives a miss's bits."""
    m, k, n = 512, 384, 512
    a = _stored((m, k), False, torch.bfloat16, 70)
    b = _stored((k, n), False, torch.bfloat16, 71, 0.05)
    kw = dict(a_mode="block", b_mode="tile")
    _, key = fm.resolve_qmm_tiles(a, b, "block", "tile", False, False)
    try:
        ta.set_table(ta.TuningTable())
        y_miss = fm.fused_qmm(a, b, **kw)
        table = ta.TuningTable()
        table.record(key, *tiles, 128, 1.0)
        ta.set_table(table)
        before = qs.KERNEL.tile_launches.get(tiles, 0)
        y_hit = fm.fused_qmm(a, b, **kw)
        assert qs.KERNEL.tile_launches[tiles] == before + 1
    finally:
        ta.set_table(None)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y_hit), _bits(y_miss))


@pytest.mark.parametrize("tiles", [(384, 128), (256, 256), (64, 128)])
@pytest.mark.parametrize("kernel", ["qmm_stream", "tiled_mm"])
def test_explicit_unbuilt_tiling_raises_on_cuda(cuda, kernel, tiles):
    a = _stored((256, 256), False, torch.bfloat16, 72)
    b = _stored((256, 256), False, torch.bfloat16, 73)
    launches = (qs.KERNEL.launches, tm.KERNEL.launches)
    with pytest.raises(ValueError, match="no kernel is built"):
        if kernel == "qmm_stream":
            qs.qmm_stream(a, b, a_mode="block", b_mode="tile",
                          a_fmt="fp4_e2m1", b_fmt="fp4_e2m1", bm=tiles[0],
                          bn=tiles[1])
        else:
            tm.tiled_mm(a, b, bm=tiles[0], bn=tiles[1])
    with pytest.raises(ValueError, match="no kernel is built"):
        fm.fused_qmm(a, b, bm=tiles[0], bn=tiles[1])
    assert (qs.KERNEL.launches, tm.KERNEL.launches) == launches


def test_autotune_qmm_records_the_lookup_key(cuda):
    """The sweep times every built candidate and records the fastest
    under the key ``fused_qmm`` then resolves to it."""
    table, times = ta.TuningTable(), {}
    tiles, us = ta.autotune_qmm(500, 512, 384, a_mode="block",
                                b_mode="tile", dtype="bfloat16", reps=2,
                                table=table, times=times)
    assert set(times) == set(TILINGS) and us == min(times.values()) > 0
    assert times[tiles] == us
    a = _stored((500, 384), False, torch.bfloat16, 74)
    b = _stored((384, 512), False, torch.bfloat16, 75)
    _, key = fm.resolve_qmm_tiles(a, b, "block", "tile", False, False)
    assert table.lookup(key) == tiles
