"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``; each test skips without a CUDA device.  No JAX
here: the card's machine has none.  Run on the card with

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        -m gpu tests/test_torch_kernels_gpu.py

(``--noconftest``: tests/conftest.py imports JAX.)  Bars: QDQ panels
bitwise; GEMM outputs within f32 rtol 1e-5 / atol 1e-5 * max|y|, or
one bf16 ulp (2^-7 |y|) + 1e-5 * max|y| in bf16 (the
kernels and cuBLAS sum in different orders); the stream pipeline bitwise
equal to quantize pass + matmul pass (both kernels sum in k order).
"""
import pytest
import torch

from repro_torch.core.packed import pack_tensor
from repro_torch.core.qlinear import qlinear
from repro_torch.core.quantize import QuantSpec
from repro_torch.core.recipe import MatmulRecipe
from repro_torch.kernels import fp4_matmul as fm
from repro_torch.kernels import qmm_stream as qs
from repro_torch.kernels import quantize_rows as qr
from repro_torch.kernels import tiled_mm as tm

pytestmark = pytest.mark.gpu

DTYPES = (torch.float32, torch.bfloat16)
# M = 1, M not a multiple of 128, K = 64 (one short group), K ragged.
SHAPES = ((1, 768, 3072), (130, 768, 768), (8, 64, 3072), (130, 200, 96))


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


def test_unported_modes_raise_on_cuda(cuda):
    """Stochastic rounding, the stats epilogue and the transposed layouts
    raise on a CUDA tensor instead of running the plain version."""
    a = _rand((8, 128), torch.bfloat16, 5)
    b = _rand((128, 128), torch.bfloat16, 6)
    with pytest.raises(NotImplementedError):
        qr.quantize_rows(a, mode="token", fmt_name="fp8_e4m3", sr=True)
    with pytest.raises(NotImplementedError):
        qr.quantize_rows(a, mode="token", fmt_name="fp8_e4m3",
                         collect_stats=True)
    for kw in ({"a_sr": True}, {"collect_stats": True}, {"trans_b": True}):
        with pytest.raises(NotImplementedError):
            fm.fused_qmm(a, b, a_mode="block", b_mode="pass",
                         b_fmt="bf16", **kw)
    with pytest.raises(NotImplementedError):
        tm.tiled_mm(a, b, trans_a=True)
    launched = (qr.KERNEL.launches, qs.KERNEL.launches, tm.KERNEL.launches)
    with pytest.raises(NotImplementedError):
        fm.fused_qmm(a, b, a_mode="token", b_mode="pass", b_fmt="bf16",
                     a_sr=True)
    assert (qr.KERNEL.launches, qs.KERNEL.launches,
            tm.KERNEL.launches) == launched


def _launches():
    return (qr.KERNEL.launches, qs.KERNEL.launches, tm.KERNEL.launches)


@pytest.mark.parametrize("packed", [False, True])
def test_spec_outside_the_kernels_raises_on_cuda(cuda, packed):
    """Block size 64 is no kernel mode: under ``linear_impl="pallas"`` a
    CUDA tensor raises instead of running the plain QDQ matmul."""
    x = _rand((8, 256), torch.bfloat16, 7)
    w = _rand((256, 128), torch.bfloat16, 8) * 0.05
    if packed:
        w = pack_tensor(w, QuantSpec.from_str("fp4_e2m1@tile128"))
    recipe = MatmulRecipe(fwd_x=QuantSpec.from_str("fp4_e2m1@block64"),
                          fwd_w=QuantSpec.from_str("fp4_e2m1@tile64"))
    launched = _launches()
    with pytest.raises(NotImplementedError, match="unsupported_block"):
        qlinear(x, w, recipe, impl="pallas")
    assert _launches() == launched


def test_launch_counts(cuda):
    """The counters count kernels launched: none for an empty output, two
    for tensor mode (whole-tensor amax, then the QDQ)."""
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
