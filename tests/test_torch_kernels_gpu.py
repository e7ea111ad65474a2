"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test skips without a CUDA device.  No JAX
here: the card's machine has none.  Run on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py imports JAX.)  Bars: QDQ panels
bitwise; GEMM outputs within f32 rtol 1e-5 / atol 1e-5 * max|y|, or
one bf16 ulp (2^-7 |y|) + 1e-5 * max|y| in bf16 (the
kernels and cuBLAS sum in different orders); the stream pipeline bitwise
equal to quantize pass + matmul pass, in every trans layout (both kernels
take one route by dtype and M, and on each route sum every output element
over k in increasing order with the same instructions: FMA loops for f32
and M <= 16, gemm_sm90.cuh's wgmma main loop for bf16 with M > 16); rows
of a tensor-core call bitwise equal to the same rows of a call with
fewer rows; flash attention within f32 rtol / atol 1e-5 or one
bf16 ulp + 1e-5 of its plain version; the autograd Functions' gradients
on the card within the GEMM bar (qlinear) or 1e-4 (attention, f32) of
the same Functions on the CPU.  Stochastic rounding: QDQ panels bitwise
(the noise is the counter hash of each element's coordinates).  Stats
vectors: lanes 0-2 and 5-7 (counts, scale extrema) bitwise, lanes 3-4
(sums of squares) within rtol 1e-6 of the plain version, and bitwise
between the two pipelines.  ``quantize_blockwise`` bitwise.  Batched
launches (3-D operands, the MoE experts): bitwise equal to one launch
per pair and to the plain version pair by pair (GEMMs within the GEMM
bar); an olmoe-1b-7b MoE decode step of 4 slots bitwise equal to 1-slot
steps.  mamba2-780m's in_dt (N = 48, below one tile) in every role on
both routes, and its packed panel, under the same bars.
"""
import pytest
import torch

from repro_torch.core.packed import pack_tensor
from repro_torch.core.qlinear import qlinear
from repro_torch.core.quantize import QuantSpec
from repro_torch.core.recipe import MM_FFN_PAPER, MM_FP8, MatmulRecipe
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fp4_matmul as fm
from repro_torch.kernels import ops
from repro_torch.kernels import qmm_stream as qs
from repro_torch.kernels import quantize as qb
from repro_torch.kernels import quantize_rows as qr
from repro_torch.kernels import tiled_mm as tm
from repro_torch.kernels.build import TILINGS

pytestmark = pytest.mark.gpu

DTYPES = (torch.float32, torch.bfloat16)
# M = 1, M not a multiple of 128, K = 64 (one short group), K ragged;
# several 128 x 128 tensor-core tiles, ragged every way and aligned.
SHAPES = ((1, 768, 3072), (130, 768, 768), (8, 64, 3072), (130, 200, 96),
          (257, 384, 320), (256, 256, 256))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(shape, dtype, seed, zero_rows=()):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(*shape, generator=g, device="cuda") * 3
    for r in zero_rows:
        x[r] = 0            # all-zero rows take the eps-floored scale
    return x.to(dtype)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _assert_gemm_close(y, ref):
    assert y.dtype == ref.dtype
    rtol = 2.0 ** -7 if y.dtype == torch.bfloat16 else 1e-5
    y, ref = y.float(), ref.float()
    top = ref.abs().max()
    assert ((y - ref).abs() <= rtol * ref.abs() + 1e-5 * top).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,fmt", [("token", "fp8_e4m3"),
                                      ("block", "fp4_e2m1"),
                                      ("tile", "fp4_e2m1"),
                                      ("tensor", "fp8_e5m2")])
@pytest.mark.parametrize("shape", [(1, 768), (130, 768), (8, 64),
                                   (130, 200)])
def test_quantize_rows_bitwise(cuda, shape, mode, fmt, dtype):
    x = _rand(shape, dtype, 0, zero_rows=(0,) if shape[0] > 1 else ())
    y = qr.quantize_rows(x, mode=mode, fmt_name=fmt)
    ref = qr.quantize_rows_plain(x, mode=mode, fmt_name=fmt)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("a_mode,b_mode", [("block", "pass"),
                                           ("tile", "block"),
                                           ("pass", "tile")])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_qmm_stream_matches_plain_and_two_pass(cuda, m, k, n, a_mode,
                                               b_mode, dtype):
    a = _rand((m, k), dtype, 1, zero_rows=(0,))
    b = _rand((k, n), dtype, 2) * 0.05
    kw = dict(a_mode=a_mode, b_mode=b_mode, a_fmt="fp4_e2m1",
              b_fmt="fp8_e4m3")
    y = qs.qmm_stream(a, b, **kw)
    _assert_gemm_close(y, qs.qmm_stream_plain(a, b, **kw))
    two = fm.fused_qmm(a, b, pipeline="two_pass", **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(two))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tiled_mm_matches_plain(cuda, m, k, n, dtype):
    a, b = _rand((m, k), dtype, 3), _rand((k, n), dtype, 4)
    _assert_gemm_close(tm.tiled_mm(a, b), tm.tiled_mm_plain(a, b))


def _assert_stats(got, ref):
    """Counts and scale extrema bitwise, the two sums within rtol 1e-6."""
    assert got.shape == ref.shape == (8,)
    lanes = [0, 1, 2, 5, 6, 7]
    assert torch.equal(got[lanes].cpu(), ref[lanes].cpu()), (got, ref)
    torch.testing.assert_close(got[3:5].cpu(), ref[3:5].cpu(), rtol=1e-6,
                               atol=0)


def test_sr_and_stats_launch_on_cuda(cuda):
    """Stochastic rounding and the stats epilogue launch their kernels on
    a CUDA tensor (the counters show it); a stochastic spec without a
    seed raises."""
    a = _rand((8, 128), torch.bfloat16, 5)
    b = _rand((128, 128), torch.bfloat16, 6)
    kernels = (qr.KERNEL, qs.KERNEL, tm.KERNEL)
    before = [(k.sr_launches, k.stats_launches) for k in kernels]
    qr.quantize_rows(a, mode="token", fmt_name="fp8_e4m3", sr=True, seed=3)
    y, stats = qr.quantize_rows(a, mode="token", fmt_name="fp8_e4m3",
                                collect_stats=True)
    assert stats.shape == (8,) and stats.device.type == "cuda"
    for pipeline in ("stream", "two_pass"):
        y, (sa, sb) = fm.fused_qmm(a, b, a_mode="block", b_mode="pass",
                                   b_fmt="bf16", a_sr=True, seed_a=1,
                                   trans_b=True, pipeline=pipeline,
                                   collect_stats=True)
        assert sb is None and sa.shape == (8,)
    after = [(k.sr_launches, k.stats_launches) for k in kernels]
    assert after[0][0] > before[0][0] and after[0][1] > before[0][1]
    assert after[1][0] > before[1][0] and after[1][1] > before[1][1]
    with pytest.raises(ValueError, match="seed"):
        qr.quantize_rows(a, mode="token", fmt_name="fp8_e4m3", sr=True)


def _launches():
    return (qr.KERNEL.launches, qs.KERNEL.launches, tm.KERNEL.launches)


@pytest.mark.parametrize("packed", [False, True])
def test_spec_outside_the_kernels_raises_on_cuda(cuda, packed):
    """Block size 64 is no kernel mode: under ``linear_impl="pallas"`` a
    CUDA tensor takes the reference's QDQ fallback, as a CPU tensor does
    (it raised before the fallback was ported to the card): ``dot_qdq``'s
    values, no kernel launched, the census records ``qdq_fallback``
    with the reference's reason string, and outside a capture a warning
    says so once per spec pair."""
    import warnings
    from repro_torch.core import qlinear as qlinear_mod
    from repro_torch.core import routing
    from repro_torch.core.qlinear import dot_qdq
    from repro_torch.core.quantize import BF16_SPEC
    x = _rand((8, 256), torch.bfloat16, 7)
    w = _rand((256, 128), torch.bfloat16, 8) * 0.05
    spec_w = QuantSpec.from_str("fp4_e2m1@tile64")
    if packed:
        w = pack_tensor(w, QuantSpec.from_str("fp4_e2m1@tile128"))
    recipe = MatmulRecipe(fwd_x=QuantSpec.from_str("fp4_e2m1@block64"),
                          fwd_w=spec_w)
    launched = _launches()
    qlinear_mod._FALLBACK_WARNED.clear()
    with pytest.warns(RuntimeWarning, match="qdq_fallback"):
        y = qlinear(x, w, recipe, impl="pallas")      # outside a capture
    with routing.capture() as log, warnings.catch_warnings():
        warnings.simplefilter("error")                # warned once only
        assert torch.equal(qlinear(x, w, recipe, impl="pallas"), y)
    assert _launches() == launched
    if packed:
        want = dot_qdq(x, w.dequantize().to(x.dtype), recipe.fwd_x,
                       BF16_SPEC)
        reasons = ["lhs: unsupported_block: block64 (kernel group size is "
                   "128)"]
    else:
        want = dot_qdq(x, w, recipe.fwd_x, spec_w)
        reasons = ["lhs: unsupported_block: block64 (kernel group size is "
                   "128)", "rhs: unsupported_block: tile64 (kernel group "
                   "size is 128)"]
    assert y.device.type == "cuda" and torch.equal(y, want)
    (ev,) = log.cells()
    assert ev.route == "qdq_fallback" and list(ev.reasons) == reasons


def test_launch_counts(cuda):
    """The counters count kernels launched: none for an empty output, two
    for tensor mode and for a transposed token launch (the cross-block
    amax, then the QDQ), two more for the stats fold."""
    x = _rand((8, 256), torch.bfloat16, 9)
    launched = _launches()
    qr.quantize_rows(x[:0], mode="token", fmt_name="fp8_e4m3")
    qs.qmm_stream(x[:0], x.T.contiguous(), a_mode="block", b_mode="pass",
                  a_fmt="fp4_e2m1", b_fmt="bf16")
    tm.tiled_mm(x[:0], x.T.contiguous())
    assert _launches() == launched
    qr.quantize_rows(x, mode="tensor", fmt_name="fp8_e4m3")
    qr.quantize_rows(x, mode="token", fmt_name="fp8_e4m3")
    assert qr.KERNEL.launches == launched[0] + 3
    qr.quantize_rows(x, mode="token", fmt_name="fp8_e4m3",
                     collect_stats=True)
    assert qr.KERNEL.launches == launched[0] + 6
    qr.quantize_rows(x, mode="token", fmt_name="fp8_e4m3", trans=True,
                     emit_trans=True)
    assert qr.KERNEL.launches == launched[0] + 8
    qs.qmm_stream(x, x.T.contiguous(), a_mode="block", b_mode="tile",
                  a_fmt="fp4_e2m1", b_fmt="fp4_e2m1", collect_stats=True)
    assert qs.KERNEL.launches == launched[1] + 3


# -- the training slice: transposed layouts, flash attention, autograd --

TRANS = [(False, False), (True, False), (False, True), (True, True)]
# M ragged, K ragged (one short group), N ragged; M = 1; several
# tensor-core tiles, ragged every way and aligned.
TRANS_SHAPES = ((130, 200, 96), (1, 768, 256), (257, 384, 320),
                (256, 256, 256))


def _stored(shape, trans, dtype, seed, scale=1.0):
    """A random operand whose effective (trans-applied) shape is
    ``shape``, stored transposed under ``trans``."""
    x = _rand(shape[::-1] if trans else shape, dtype, seed) * scale
    return x.contiguous()


@pytest.mark.parametrize("kernel", ["qmm_stream", "tiled_mm"])
@pytest.mark.parametrize("dtype,m,tc", [(torch.bfloat16, 17, True),
                                        (torch.bfloat16, 300, True),
                                        (torch.bfloat16, 16, False),
                                        (torch.bfloat16, 1, False),
                                        (torch.float32, 300, False)])
def test_route_counters(cuda, kernel, dtype, m, tc):
    """bf16 with M > 16 takes the tensor-core route, f32 or M <= 16 the
    FMA route; the counters say which ran."""
    a, b = _rand((m, 256), dtype, 40), _rand((256, 192), dtype, 41)
    kern = qs.KERNEL if kernel == "qmm_stream" else tm.KERNEL
    before = kern.counts()
    if kernel == "qmm_stream":
        qs.qmm_stream(a, b, a_mode="block", b_mode="tile", a_fmt="fp4_e2m1",
                      b_fmt="fp4_e2m1")
    else:
        tm.tiled_mm(a, b)
    after = kern.counts()
    assert after["launches"] == before["launches"] + 1
    assert after["tc"] == before["tc"] + tc
    assert kern.tensor_core(1 if dtype == torch.bfloat16 else 0, m) == tc


@pytest.mark.parametrize("tiles", [t[:2] for t in TILINGS])
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("kernel", ["qmm_stream", "tiled_mm"])
def test_rows_do_not_depend_on_m(cuda, kernel, trans_a, trans_b, tiles):
    """On the tensor-core route a row's result does not depend on the
    other rows: rows 0-16 of an M = 300 call bitwise equal an M = 17 call
    on the same first 17 rows, in every layout, at every tiling."""
    a = _stored((300, 384), trans_a, torch.bfloat16, 42)
    b = _stored((384, 320), trans_b, torch.bfloat16, 43, 0.05)
    a17 = (a[:, :17] if trans_a else a[:17]).contiguous()
    kw = dict(trans_a=trans_a, trans_b=trans_b, bm=tiles[0], bn=tiles[1])
    if kernel == "qmm_stream":
        kw.update(a_mode="block", b_mode="tile", a_fmt="fp4_e2m1",
                  b_fmt="fp4_e2m1")
        fn, kern = qs.qmm_stream, qs.KERNEL
    else:
        fn, kern = tm.tiled_mm, tm.KERNEL
    tc = kern.tc_launches
    y, y17 = fn(a, b, **kw), fn(a17, b, **kw)
    torch.cuda.synchronize()
    assert kern.tc_launches == tc + 2
    assert torch.equal(_bits(y[:17]), _bits(y17))


# (300, 1100): a transposed launch over several strips and 128-column
# chunks, ragged both ways; (768, 8192): the attention wgrad's operands.
QUANT_SHAPES = ((130, 200), (1, 768), (300, 8), (300, 1100), (768, 8192))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans,emit_trans", [(False, True), (True, False),
                                              (True, True)])
@pytest.mark.parametrize("mode,fmt", [("token", "fp8_e5m2"),
                                      ("block", "fp8_e4m3"),
                                      ("tile", "fp4_e2m1"),
                                      ("tensor", "fp8_e5m2")])
@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_quantize_rows_transposed_bitwise(cuda, shape, mode, fmt, trans,
                                          emit_trans, dtype):
    """The quantize pass reading the stored operand transposed and / or
    writing its result transposed, ragged edges both ways."""
    x = _stored(shape, trans, dtype, 10)
    kw = dict(mode=mode, fmt_name=fmt, trans=trans, emit_trans=emit_trans)
    y = qr.quantize_rows(x, **kw)
    ref = qr.quantize_rows_plain(x, **kw)
    torch.cuda.synchronize()
    assert y.shape == ref.shape
    assert torch.equal(_bits(y), _bits(ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("b_mode", ["pass", "block", "tile"])
@pytest.mark.parametrize("a_mode", ["pass", "block", "tile"])
@pytest.mark.parametrize("m,k,n", TRANS_SHAPES)
def test_qmm_stream_transposed(cuda, m, k, n, a_mode, b_mode, trans_a,
                               trans_b, dtype):
    """Every (mode, trans_a, trans_b) of the stream kernel against its
    plain version, and bitwise against quantize pass + matmul pass in the
    same layout."""
    a = _stored((m, k), trans_a, dtype, 11)
    b = _stored((k, n), trans_b, dtype, 12, 0.05)
    kw = dict(a_mode=a_mode, b_mode=b_mode, a_fmt="fp8_e4m3",
              b_fmt="fp8_e5m2", trans_a=trans_a, trans_b=trans_b)
    y = qs.qmm_stream(a, b, **kw)
    assert y.shape == (m, n)
    _assert_gemm_close(y, qs.qmm_stream_plain(a, b, **kw))
    two = fm.fused_qmm(a, b, pipeline="two_pass", **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(two))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_tiled_mm_transposed(cuda, m, k, n, trans_a, trans_b, dtype):
    a = _stored((m, k), trans_a, dtype, 13)
    b = _stored((k, n), trans_b, dtype, 14)
    kw = dict(trans_a=trans_a, trans_b=trans_b)
    _assert_gemm_close(tm.tiled_mm(a, b, **kw), tm.tiled_mm_plain(a, b, **kw))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("a_mode,b_mode", [("token", "token"),
                                           ("tensor", "block")])
def test_two_pass_token_modes_transposed(cuda, a_mode, b_mode, trans_a,
                                         trans_b, dtype):
    """Token / tensor modes (the attention linears' two-pass route) in
    every trans layout against the plain pipeline, ragged 130 x 200 x
    96."""
    a = _stored((130, 200), trans_a, dtype, 15)
    b = _stored((200, 96), trans_b, dtype, 16, 0.05)
    kw = dict(a_mode=a_mode, b_mode=b_mode, a_fmt="fp8_e5m2",
              b_fmt="fp8_e4m3", trans_a=trans_a, trans_b=trans_b)
    y = fm.fused_qmm(a, b, **kw)
    _assert_gemm_close(y, fm.fused_qmm(a.cpu(), b.cpu(), **kw).cuda())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("s", [128, 192, 1024])
@pytest.mark.parametrize("rep", [1, 2, 4])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_attention_matches_plain(cuda, d, rep, s, dtype, causal):
    """Every head dimension (1/sqrt(D) a power of two for 16 and 64, not
    for 32 and 128), GQA by index, S = 192 (a ragged 128-row q tile of
    the tensor-core route), causal and not (an encoder's attention)."""
    q = _rand((4, s, d), dtype, 17)
    k, v = _rand((4 // rep, s, d), dtype, 18), _rand((4 // rep, s, d),
                                                    dtype, 19)
    o = fa.flash_attention_fwd(q, k, v, causal=causal)
    ref = fa.flash_attention_fwd_plain(q, k, v, causal=causal)
    assert o.dtype == q.dtype and o.shape == q.shape
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(o.float(), ref.float(), rtol=rtol, atol=1e-5)


@pytest.mark.parametrize("dtype,tc", [(torch.bfloat16, True),
                                      (torch.float32, False)])
def test_flash_attention_route(cuda, dtype, tc):
    """bf16 takes the tensor-core route, f32 the FMA route; the counters
    say which ran."""
    q, k, v = (_rand((2, 128, 64), dtype, seed) for seed in (44, 45, 46))
    before = fa.KERNEL.counts()
    fa.flash_attention_fwd(q, k, v)
    after = fa.KERNEL.counts()
    assert after["launches"] == before["launches"] + 1
    assert after["tc"] == before["tc"] + tc
    assert fa.KERNEL.tensor_core(1 if dtype == torch.bfloat16 else 0) == tc


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("recipe", [MM_FP8, MM_FFN_PAPER],
                         ids=["MM_FP8", "MM_FFN_PAPER"])
def test_qlinear_grads_card_vs_cpu(cuda, recipe, dtype):
    """The STE backward on the card (dgrad with w read transposed, wgrad
    with x read transposed) against the same Function on the CPU on the
    same inputs: outputs and both gradients within the GEMM bar."""
    x = _rand((300, 256), dtype, 20)
    w = _rand((256, 192), dtype, 21) * 0.05
    g = _rand((300, 192), dtype, 22)
    out = []
    for dev in ("cuda", "cpu"):
        xd, wd = (t.detach().to(dev).requires_grad_() for t in (x, w))
        y = qlinear(xd, wd, recipe, impl="pallas")
        y.backward(g.to(dev))
        out.append((y, xd.grad, wd.grad))
    for a, b in zip(*out):
        assert a.dtype == b.dtype == dtype
        _assert_gemm_close(a, b.cuda())


def test_flash_attention_grads_card_vs_cpu(cuda):
    """``ops.flash_attention`` (kernel forward, chunked backward) on the
    card against the CPU, f32, GQA 4 / 2 heads: rtol / atol 1e-4."""
    q = _rand((2, 256, 4, 16), torch.float32, 23)
    k, v = (_rand((2, 256, 2, 16), torch.float32, s) for s in (24, 25))
    g = _rand((2, 256, 4, 16), torch.float32, 26)
    out = []
    for dev in ("cuda", "cpu"):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        o = ops.flash_attention(*leaves, chunk=128)
        o.backward(g.to(dev))
        out.append([o] + [t.grad for t in leaves])
    for a, b in zip(*out):
        torch.testing.assert_close(a, b.cuda(), rtol=1e-4, atol=1e-4)


# -- stochastic rounding, the stats epilogue, quantize_blockwise --------

SEED = -1253433917      # fold_seed((0, 0), 4, 1): the FFN wgrad's B seed


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans,emit_trans", [(False, False), (True, True),
                                              (True, False)])
@pytest.mark.parametrize("mode,fmt", [("token", "fp8_e5m2"),
                                      ("block", "fp4_e2m1"),
                                      ("tile", "fp4_e2m1"),
                                      ("tensor", "fp8_e4m3")])
@pytest.mark.parametrize("shape", QUANT_SHAPES)
def test_quantize_rows_sr_stats(cuda, shape, mode, fmt, trans, emit_trans,
                                dtype):
    """SR panels bitwise and the stats vector against the plain version,
    ragged both ways, every read / write layout."""
    x = _stored(shape, trans, dtype, 30)
    kw = dict(mode=mode, fmt_name=fmt, trans=trans, emit_trans=emit_trans,
              collect_stats=True)
    y, st = qr.quantize_rows(x, sr=True, seed=SEED, **kw)
    ref, st_ref = qr.quantize_rows_plain(x, seed=SEED, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(ref))
    _assert_stats(st, st_ref)
    # RTN with stats: the same values as without
    y_rtn, st_rtn = qr.quantize_rows(x, **kw)
    kw.pop("collect_stats")
    assert torch.equal(_bits(y_rtn), _bits(qr.quantize_rows(x, **kw)))
    _assert_stats(st_rtn, qr.quantize_rows_plain(x, collect_stats=True,
                                                 **kw)[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("a_mode,b_mode", [("block", "tile"),
                                           ("tile", "block"),
                                           ("pass", "block"),
                                           ("block", "pass")])
@pytest.mark.parametrize("m,k,n", TRANS_SHAPES + ((8, 64, 3072),))
def test_qmm_stream_sr_stats(cuda, m, k, n, a_mode, b_mode, trans_a,
                             trans_b, dtype):
    """The stream kernel with SR on both operands and the stats epilogue:
    output within the GEMM bar of the plain version and bitwise equal to
    the two-pass pipeline (SR quantize pass + matmul pass), stats against
    the plain version and bitwise against the two-pass stats."""
    a = _stored((m, k), trans_a, dtype, 31)
    b = _stored((k, n), trans_b, dtype, 32, 0.05)
    kw = dict(a_mode=a_mode, b_mode=b_mode, a_fmt="fp4_e2m1",
              b_fmt="fp8_e5m2", trans_a=trans_a, trans_b=trans_b,
              collect_stats=True)
    seeds = dict(seed_a=SEED, seed_b=7)
    y, stats = qs.qmm_stream(a, b, a_sr=True, b_sr=True, **seeds, **kw)
    ref, ref_stats = qs.qmm_stream_plain(a, b, **seeds, **kw)
    _assert_gemm_close(y, ref)
    two, two_stats = fm.fused_qmm(a, b, a_sr=True, b_sr=True,
                                  pipeline="two_pass", **seeds, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(two))
    for got, r, t in zip(stats, ref_stats, two_stats):
        assert (got is None) == (r is None) == (t is None)
        if got is not None:
            _assert_stats(got, r)
            assert torch.equal(got, t)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("fmt", ["fp4_e2m1", "fp8_e4m3"])
@pytest.mark.parametrize("shape", [(130, 200), (1, 768), (300, 8),
                                   (256, 384)])
def test_quantize_blockwise_bitwise(cuda, shape, fmt, per_row, dtype):
    x = _rand(shape, dtype, 33, zero_rows=(0,) if shape[0] > 1 else ())
    y = qb.quantize_blockwise(x, fmt, per_row=per_row)
    ref = qb.quantize_blockwise_plain(x, fmt, per_row=per_row)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype
    assert torch.equal(_bits(y), _bits(ref))


def test_qlinear_sr_stats_grads_card_vs_cpu(cuda):
    """``pallas_qmatmul_stats`` under the fine_grained_fp4 FFN recipe (SR
    wgrad gradient operand) on the card against the same Function on the
    CPU: y, dx, dw within the GEMM bar, the forward stats to the stats
    bar."""
    from repro_torch.core.qlinear import pallas_qmatmul_stats
    from repro_torch.core.recipe import RECIPES
    recipe = RECIPES["fine_grained_fp4"].ffn_linear
    x = _rand((300, 256), torch.bfloat16, 34)
    w = _rand((256, 192), torch.bfloat16, 35) * 0.05
    g = _rand((300, 192), torch.bfloat16, 36)
    out = []
    for dev in ("cuda", "cpu"):
        xd, wd = (t.detach().to(dev).requires_grad_() for t in (x, w))
        y, stats = pallas_qmatmul_stats(xd, wd, recipe)
        y.backward(g.to(dev))
        out.append((y, xd.grad, wd.grad, stats))
    for a, b in zip(out[0][:3], out[1][:3]):
        _assert_gemm_close(a, b.cuda())
    for a, b in zip(out[0][3], out[1][3]):
        _assert_stats(a, b)


# -- quantize_blockwise's one-pass kernel; llama-1b's training shapes ----

def _blockwise_check(x, fmt, per_row):
    y = qb.quantize_blockwise(x, fmt, per_row=per_row)
    ref = qb.quantize_blockwise_plain(x, fmt, per_row=per_row)
    torch.cuda.synchronize()
    assert y.dtype == x.dtype and y.shape == x.shape
    assert torch.equal(_bits(y), _bits(ref))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("fmt", ["fp4_e2m1", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("shape", [(1, 1), (1, 300), (300, 1), (129, 130),
                                   (1280, 3392), (8192, 768)])
def test_quantize_blockwise_shapes(cuda, shape, fmt, per_row, dtype):
    """Aligned, ragged (llama-1b's w_gate, 1280 x 3392: a 64-column last
    tile), 1-row and 1-column shapes, bitwise against the plain version;
    a row length that is no multiple of a 16-byte chunk takes the scalar
    accesses."""
    _blockwise_check(_rand(shape, dtype, 50), fmt, per_row)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_row", [False, True])
def test_quantize_blockwise_unaligned_start(cuda, per_row, dtype):
    """A contiguous operand whose first element is not 16-byte aligned
    (a view one element into its storage) takes the scalar accesses."""
    flat = _rand((257 * 256 + 1,), dtype, 51)
    _blockwise_check(flat[1:].view(257, 256), "fp4_e2m1", per_row)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("fmt", ["fp4_e2m1", "fp8_e4m3", "fp8_e5m2"])
@pytest.mark.parametrize("kind", ["zero", "subnormal_scale", "ties"])
def test_quantize_blockwise_worst_cases(cuda, kind, fmt, per_row, dtype):
    """Tiles where the kernel's division (reciprocal + two FMA remainder
    steps) must equal the IEEE one bit for bit: all-zero tiles (the
    eps-floored scale), tiles of tiny values (the scale near the eps
    floor; subnormal inputs in f32), and values within a few ulp of every
    midpoint of the grid at a scale with a full mantissa, where a quotient
    one ulp off would round the other way."""
    from repro_torch.core.formats import FORMATS, format_values_host
    g = torch.Generator(device="cuda").manual_seed(52)
    rows, cols = 256, 384
    if kind == "zero":
        x = torch.zeros(rows, cols, device="cuda")
        x[128:, 128:] = torch.randn(128, 256, generator=g, device="cuda")
    elif kind == "subnormal_scale":
        tiny = 1e-40 if dtype == torch.float32 else 1e-38
        x = torch.randn(rows, cols, generator=g, device="cuda") * tiny
    else:
        fmt_ = FORMATS[fmt]
        grid = torch.tensor(format_values_host(fmt_), device="cuda")
        mids = (grid[1:] + grid[:-1]) / 2
        amax = (1.0 + torch.rand(rows // 128, 1, generator=g,
                                 device="cuda") * 7).repeat_interleave(128, 0)
        pick = torch.randint(0, len(mids), (rows, cols), generator=g,
                             device="cuda")
        x = amax / fmt_.max_value * mids[pick]
        ulp = torch.randint(-2, 3, (rows, cols), generator=g, device="cuda")
        x = torch.where(ulp > 0, torch.nextafter(x, x * 2), x)
        x = torch.where(ulp < 0, torch.nextafter(x, x * 0), x)
        sign = torch.randint(0, 2, (rows, cols), generator=g,
                             device="cuda") * 2 - 1
        x = x * sign
        x[:, ::128] = amax        # every row segment and tile holds amax
    _blockwise_check(x.to(dtype).contiguous(), fmt, per_row)


# llama-1b's FFN at 8192 tokens (d 1280, d_ff 3392 = 26 x 128 + 64: a
# short last group on the tensor-core route as N, K and M), under
# paper_fp4's roles: forward fp4 block x tile, dgrad pass x pass (the
# weight read transposed), wgrad fp8 block x block (the input read
# transposed, K = 8192).
LLAMA_FFN = (("w_gate", 1280, 3392), ("w_down", 3392, 1280))


@pytest.mark.parametrize("role", ["fwd", "dgrad", "wgrad"])
@pytest.mark.parametrize("name,d_in,d_out", LLAMA_FFN)
def test_qmm_stream_llama_ffn_shapes(cuda, name, d_in, d_out, role):
    t = 8192
    if role == "fwd":          # x (t, d_in) @ w (d_in, d_out)
        a, b = _rand((t, d_in), torch.bfloat16, 53), \
            _rand((d_in, d_out), torch.bfloat16, 54) * 0.05
        kw = dict(a_mode="block", b_mode="tile", a_fmt="fp4_e2m1",
                  b_fmt="fp4_e2m1")
    elif role == "dgrad":      # g (t, d_out) @ w^T, w stored (d_in, d_out)
        a, b = _rand((t, d_out), torch.bfloat16, 55) * 0.01, \
            _rand((d_in, d_out), torch.bfloat16, 54) * 0.05
        kw = dict(a_mode="pass", b_mode="pass", a_fmt="bf16", b_fmt="bf16",
                  trans_b=True)
    else:                      # x^T @ g, x stored (t, d_in)
        a, b = _rand((t, d_in), torch.bfloat16, 53), \
            _rand((t, d_out), torch.bfloat16, 55) * 0.01
        kw = dict(a_mode="block", b_mode="block", a_fmt="fp8_e4m3",
                  b_fmt="fp8_e4m3", trans_a=True)
    tc = qs.KERNEL.tc_launches
    y = qs.qmm_stream(a, b, **kw)
    assert qs.KERNEL.tc_launches == tc + 1
    _assert_gemm_close(y, qs.qmm_stream_plain(a, b, **kw))
    two = fm.fused_qmm(a, b, pipeline="two_pass", **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(two))


@pytest.mark.parametrize("role", ["fwd", "dgrad", "wgrad"])
def test_tiled_mm_llama_attention_shapes(cuda, role):
    """The attention linears' matmul pass at llama-1b's 8192 x 1280 x
    1280, in the step's three layouts."""
    t, d = 8192, 1280
    x, w = _rand((t, d), torch.bfloat16, 56), \
        _rand((d, d), torch.bfloat16, 57) * 0.05
    a, b, kw = {"fwd": (x, w, {}),
                "dgrad": (x, w, dict(trans_b=True)),
                "wgrad": (x, x, dict(trans_a=True))}[role]
    tc = tm.KERNEL.tc_launches
    y = tm.tiled_mm(a, b, **kw)
    assert tm.KERNEL.tc_launches == tc + 1
    _assert_gemm_close(y, tm.tiled_mm_plain(a, b, **kw))


def test_flash_attention_llama_shape(cuda):
    """llama-1b's attention at 4 x 2048 tokens: (80, 2048, 64), causal,
    bf16 on the tensor-core route."""
    q, k, v = (_rand((80, 2048, 64), torch.bfloat16, seed)
               for seed in (58, 59, 60))
    tc = fa.KERNEL.tc_launches
    o = fa.flash_attention_fwd(q, k, v)
    assert fa.KERNEL.tc_launches == tc + 1
    ref = fa.flash_attention_fwd_plain(q, k, v)
    torch.testing.assert_close(o.float(), ref.float(), rtol=2.0 ** -7,
                               atol=1e-5)


# -- batched launches (the MoE experts) ---------------------------------

# (E, M, K, N): the FMA route (M <= 16, a decode step's 8 rows an expert)
# and the tensor-core route, ragged and aligned.
BATCH_SHAPES = ((3, 8, 256, 320), (3, 130, 200, 96), (2, 257, 384, 256))


def _stored_batch(e, shape, trans, dtype, seed, scale=1.0):
    return torch.stack([_stored(shape, trans, dtype, seed + i, scale)
                        for i in range(e)]).contiguous()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("a_mode,b_mode,sr", [("block", "tile", False),
                                              ("pass", "pass", False),
                                              ("block", "block", True),
                                              ("tile", "pass", True)])
@pytest.mark.parametrize("e,m,k,n", BATCH_SHAPES)
def test_qmm_stream_batched(cuda, e, m, k, n, a_mode, b_mode, sr, trans_a,
                            trans_b, dtype):
    """One batched stream launch over E pairs: bitwise the same kernel
    launched once per pair, within the GEMM bar of the plain version
    (pair by pair, every pair with the same SR noise) and bitwise the
    batched two-pass pipeline; one launch, counted as batched."""
    a = _stored_batch(e, (m, k), trans_a, dtype, 60)
    b = _stored_batch(e, (k, n), trans_b, dtype, 70, 0.05)
    kw = dict(a_mode=a_mode, b_mode=b_mode, a_fmt="fp4_e2m1",
              b_fmt="fp8_e4m3", trans_a=trans_a, trans_b=trans_b)
    seeds = dict(a_sr=sr, b_sr=sr, seed_a=SEED, seed_b=7) if sr else {}
    before = qs.KERNEL.counts()
    y = qs.qmm_stream(a, b, **seeds, **kw)
    after = qs.KERNEL.counts()
    assert y.shape == (e, m, n)
    assert after["launches"] == before["launches"] + 1
    assert after["batched"] == before["batched"] + 1
    one = torch.stack([qs.qmm_stream(x, w, **seeds, **kw)
                       for x, w in zip(a, b)])
    plain_seeds = dict(seed_a=SEED, seed_b=7) if sr else {}
    ref = qs.qmm_stream_plain(a, b, **plain_seeds, **kw)
    two = fm.fused_qmm(a, b, pipeline="two_pass", **seeds, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(one))
    assert torch.equal(_bits(y), _bits(two))
    _assert_gemm_close(y, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans_a,trans_b", TRANS)
@pytest.mark.parametrize("e,m,k,n", BATCH_SHAPES)
def test_tiled_mm_batched(cuda, e, m, k, n, trans_a, trans_b, dtype):
    """A batched tiled_mm launch bitwise equals one launch per pair and
    is within the GEMM bar of the plain version."""
    a = _stored_batch(e, (m, k), trans_a, dtype, 80)
    b = _stored_batch(e, (k, n), trans_b, dtype, 90, 0.05)
    kw = dict(trans_a=trans_a, trans_b=trans_b)
    y = tm.tiled_mm(a, b, **kw)
    one = torch.stack([tm.tiled_mm(x, w, **kw) for x, w in zip(a, b)])
    ref = tm.tiled_mm_plain(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(one))
    _assert_gemm_close(y, ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("trans,emit_trans", [(False, False), (False, True),
                                              (True, False), (True, True)])
@pytest.mark.parametrize("mode,fmt", [("token", "fp8_e5m2"),
                                      ("block", "fp4_e2m1"),
                                      ("tile", "fp4_e2m1"),
                                      ("tensor", "fp8_e4m3")])
@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("shape", ((130, 200), (300, 1100)))
def test_quantize_rows_batched(cuda, shape, sr, mode, fmt, trans,
                               emit_trans, dtype):
    """A batched quantize pass (one tensor / token amax per operand)
    bitwise equals one launch per operand and the plain version."""
    x = _stored_batch(3, shape, trans, dtype, 100)
    x[1] *= 8         # operands of different ranges: amaxes stay apart
    kw = dict(mode=mode, fmt_name=fmt, trans=trans, emit_trans=emit_trans)
    y = qr.quantize_rows(x, sr=sr, seed=SEED, **kw)
    one = torch.stack([qr.quantize_rows(t, sr=sr, seed=SEED, **kw)
                       for t in x])
    ref = qr.quantize_rows_plain(x, seed=SEED if sr else None, **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(one))
    assert torch.equal(_bits(y), _bits(ref))


def test_moe_decode_step_is_batch_invariant(cuda):
    """A decode step of olmoe-1b-7b's MoE layer at full width (64
    experts, top-8, packed fp4 experts, paper_fp4, "pallas"): each row of
    a 4-slot step equals the same row decoded in a 1-slot step, bit for
    bit (the expert products run E x 8 rows either way; the router's
    rows are padded to one shape; the combine is a gather and a weighted
    sum in a fixed order)."""
    from repro_torch.configs import get_config
    from repro_torch.core.recipe import RECIPES
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import \
        quantize_weights_for_serving
    cfg = get_config("olmoe-1b-7b").replace(n_layers=1, vocab_size=512,
                                            linear_impl="pallas")
    model = build_model(cfg)
    params = model.cast_params(quantize_weights_for_serving(
        model, model.init(seed=1, dtype=torch.bfloat16, on_device=True),
        "fp4_e2m1"))
    recipe = RECIPES["paper_fp4"]
    before = qs.KERNEL.counts()["batched"]
    prompts = torch.randint(0, 512, (4, 40), device="cuda",
                            generator=torch.Generator("cuda").manual_seed(3))
    ones = []
    for i in range(4):
        c = model.init_cache(1, 64)
        model.prefill(params, prompts[i:i + 1], c, recipe)
        ones.append(c)
    four = model.init_cache(4, 64)
    model.prefill(params, prompts, four, recipe)
    tok = prompts[:, -1:]
    for _ in range(3):
        l4, four = model.decode_step(params, tok, four, recipe)
        for i in range(4):
            l1, ones[i] = model.decode_step(params, tok[i:i + 1], ones[i],
                                            recipe)
            assert torch.equal(l4[i], l1[0])
        tok = torch.argmax(l4[:, -1].float(), -1)[:, None]
    assert qs.KERNEL.counts()["batched"] > before


# mamba2-780m's narrowest projection, in_dt (1536 x 48: N below one
# 128-wide tile), in each role: the forward (fp4 block x fp4 tile), the
# dgrad (bf16 pass x pass, w read transposed: K = 48), the wgrad (fp8
# blocks, x read transposed: N = 48) and the packed decode (fp4 block x
# the expanded panel); M = 8 takes the FMA route, M = 1024 the tensor
# cores (the wgrad's M is 1536 and its K the tokens).
NARROW_ROLES = {
    "fwd": (lambda m: ((m, 1536), (1536, 48)),
            dict(a_mode="block", b_mode="tile", a_fmt="fp4_e2m1",
                 b_fmt="fp4_e2m1")),
    "dgrad": (lambda m: ((m, 48), (1536, 48)),
              dict(a_mode="pass", b_mode="pass", a_fmt="bf16", b_fmt="bf16",
                   trans_b=True)),
    "wgrad": (lambda m: ((m, 1536), (m, 48)),
              dict(a_mode="block", b_mode="block", a_fmt="fp8_e4m3",
                   b_fmt="fp8_e5m2", trans_a=True)),
    "decode": (lambda m: ((m, 1536), (1536, 48)),
               dict(a_mode="block", b_mode="pass", a_fmt="fp4_e2m1",
                    b_fmt="bf16")),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("role", sorted(NARROW_ROLES))
def test_narrow_projection_both_routes(cuda, role, m, dtype):
    """in_dt's roles against the plain version, bitwise against the
    two-pass pipeline (quantize_rows + tiled_mm) in the same layout, on
    the route the counters name (tensor cores for bf16 with an effective
    M > 16)."""
    shapes, kw = NARROW_ROLES[role]
    sa, sb = shapes(m)
    a, b = _rand(sa, dtype, 60), _rand(sb, dtype, 61) * 0.05
    eff_m = sa[1] if kw.get("trans_a") else sa[0]
    tc = qs.KERNEL.tc_launches
    y = qs.qmm_stream(a, b, **kw)
    want_n = sb[0] if kw.get("trans_b") else sb[1]
    assert y.shape == (eff_m, want_n)
    assert qs.KERNEL.tc_launches - tc == \
        int(dtype == torch.bfloat16 and eff_m > 16)
    _assert_gemm_close(y, qs.qmm_stream_plain(a, b, **kw))
    two = fm.fused_qmm(a, b, pipeline="two_pass", **kw)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(two))


def test_narrow_panel_packs_as_the_tile_qdq(cuda):
    """A packed 1536 x 48 panel (one partial 128 x 128 tile a row of
    tiles) decodes on the card to the tile QDQ's values, and the packed
    decode call equals the same call on those values."""
    w = _rand((1536, 48), torch.bfloat16, 62) * 0.05
    spec = QuantSpec("fp4_e2m1", "tile", 128)
    packed = pack_tensor(w, spec)
    ref = qr.quantize_rows_plain(w, mode="tile", fmt_name="fp4_e2m1",
                                 trans=True, emit_trans=True)
    assert torch.equal(_bits(packed.dequantize().to(torch.bfloat16)),
                       _bits(ref))
