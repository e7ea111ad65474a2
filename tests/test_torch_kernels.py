"""The port's quantized-matmul pipelines against the JAX reference.

JAX runs its Pallas kernels in interpret mode (``fused_qmm`` /
``pallas_qmm`` with their CPU defaults); the port runs on the CPU, where
each kernel wrapper takes its plain version.  Same numpy inputs on both
sides.  Bars: f32 rtol 1e-5 / atol 1e-5 * max|y|; bf16 one bf16 ulp
(2^-7 |y|) + 1e-5 * max|y| — the QDQ panels are bitwise equal
(test_torch_numerics), only the f32 summation order of the product
differs, which can move a bf16 output across one rounding boundary.
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.packed import pack_tensor as j_pack  # noqa: E402
from repro.core.qlinear import qlinear as j_qlinear  # noqa: E402
from repro.core.quantize import QuantSpec as JSpec  # noqa: E402
from repro.core.recipe import MatmulRecipe as JRecipe  # noqa: E402
from repro_torch.core.packed import pack_tensor as t_pack  # noqa: E402
from repro_torch.core.qlinear import qlinear as t_qlinear  # noqa: E402
from repro.kernels.ops import pallas_qmm as j_pallas_qmm  # noqa: E402
from repro_torch.core.quantize import QuantSpec as TSpec  # noqa: E402
from repro_torch.core.recipe import MatmulRecipe as TRecipe  # noqa: E402
from repro_torch.kernels import fp4_matmul as t_fm  # noqa: E402
from repro_torch.kernels import qmm_stream, quantize_rows  # noqa: E402
from repro_torch.kernels import tiled_mm  # noqa: E402
from repro_torch.kernels.ops import pallas_qmm as t_pallas_qmm  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

j_fm = importlib.import_module("repro.kernels.fp4_matmul")

RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _inputs(m, k, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    b = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    a[0] = 0                              # eps-floored scale row
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return ((jnp.asarray(a).astype(getattr(jnp, dtype)),
             jnp.asarray(b).astype(getattr(jnp, dtype))),
            (torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt)))


def _assert_close(j, t, dtype):
    ref = np.asarray(jnp.asarray(j).astype(jnp.float32))
    got = t.to(torch.float32).numpy()
    assert got.shape == ref.shape
    top = np.abs(ref).max()
    assert np.all(np.abs(got - ref) <= RTOL[dtype] * np.abs(ref)
                  + 1e-5 * top), float(np.abs(got - ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pipeline,a_mode,a_fmt", [
    ("stream", "block", "fp4_e2m1"),     # the FFN linears
    ("two_pass", "token", "fp8_e4m3"),   # the attention linears
])
@pytest.mark.parametrize("m,k,n", [(1, 64, 768), (8, 768, 3072),
                                   (130, 768, 768)])
def test_pallas_qmm_matches_jax(m, k, n, pipeline, a_mode, a_fmt, dtype):
    """The serving path's two routes (B a pre-quantized pass operand)
    through the public wrapper: JAX pads to 128 and slices, the port masks
    the ragged edges."""
    (aj, bj), (at, bt) = _inputs(m, k, n, dtype)
    yj = j_pallas_qmm(aj, bj, JSpec(a_fmt, a_mode), JSpec("bf16"),
                      mode_a=a_mode, mode_b="pass", pipeline=pipeline)
    yt = t_pallas_qmm(at, bt, TSpec(a_fmt, a_mode), TSpec("bf16"),
                      mode_a=a_mode, mode_b="pass", pipeline=pipeline)
    _assert_close(yj, yt, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("a_mode,b_mode", [("block", "tile"),
                                           ("tile", "block"),
                                           ("tensor", "token")])
def test_fused_qmm_modes_match_jax(a_mode, b_mode, dtype):
    """Quantized B operands and the other RTN modes the kernels cover,
    on 128-multiple shapes straight through ``fused_qmm``."""
    (aj, bj), (at, bt) = _inputs(128, 256, 128, dtype, seed=1)
    kw = dict(a_mode=a_mode, b_mode=b_mode, a_fmt="fp4_e2m1",
              b_fmt="fp8_e4m3")
    _assert_close(j_fm.fused_qmm(aj, bj, interpret=True, **kw),
                  t_fm.fused_qmm(at, bt, **kw), dtype)


def test_stream_equals_two_pass_on_cpu():
    """Both pipelines of the port give the same panels; on the CPU both
    end in the same plain f32 product, so the outputs are bitwise equal."""
    _, (a, b) = _inputs(130, 300, 200, "bfloat16", seed=2)
    kw = dict(a_mode="block", b_mode="tile", a_fmt="fp4_e2m1",
              b_fmt="fp4_e2m1")
    assert torch.equal(t_fm.fused_qmm(a, b, pipeline="stream", **kw),
                       t_fm.fused_qmm(a, b, pipeline="two_pass", **kw))


def test_wrappers_dispatch_by_device():
    """On a CPU tensor each wrapper runs its plain version and launches
    nothing, stochastic rounding and the stats epilogue included."""
    _, (a, b) = _inputs(8, 128, 128, "float32")
    before = [k.KERNEL.launches for k in (quantize_rows, qmm_stream,
                                          tiled_mm)]
    q = quantize_rows.quantize_rows(a, mode="token", fmt_name="fp8_e4m3")
    assert torch.equal(q, quantize_rows.quantize_rows_plain(
        a, mode="token", fmt_name="fp8_e4m3"))
    assert torch.equal(tiled_mm.tiled_mm(q, b), tiled_mm.tiled_mm_plain(q, b))
    assert [k.KERNEL.launches for k in (quantize_rows, qmm_stream,
                                        tiled_mm)] == before
    assert t_fm.resolve_pipeline(None, "token", "pass") == "two_pass"
    assert t_fm.resolve_pipeline(None, "block", "pass") == "stream"
    q, st = quantize_rows.quantize_rows(a, mode="block", fmt_name="fp4_e2m1",
                                        sr=True, seed=5, collect_stats=True)
    q_ref, st_ref = quantize_rows.quantize_rows_plain(
        a, mode="block", fmt_name="fp4_e2m1", seed=5, collect_stats=True)
    assert torch.equal(q, q_ref) and torch.equal(st, st_ref)
    y, (sa, sb) = qmm_stream.qmm_stream(a, b, a_mode="block", b_mode="pass",
                                        a_fmt="fp4_e2m1", b_fmt="bf16",
                                        a_sr=True, seed_a=5,
                                        collect_stats=True)
    assert sb is None and torch.equal(sa, st)
    assert [k.KERNEL.launches for k in (quantize_rows, qmm_stream,
                                        tiled_mm)] == before
    with pytest.raises(ValueError, match="seed"):
        quantize_rows.quantize_rows(a, mode="block", fmt_name="fp4_e2m1",
                                    sr=True)


@pytest.mark.parametrize("packed,dtype", [(False, "float32"),
                                          (True, "bfloat16")])
def test_spec_outside_the_kernels_takes_qdq_on_cpu(packed, dtype):
    """Block size 64 is no kernel mode: under ``linear_impl="pallas"`` a
    CPU tensor takes the unfused QDQ matmul, as the reference falls back
    (a CUDA tensor raises: test_torch_kernels_gpu), and launches
    nothing."""
    (aj, bj), (at, bt) = _inputs(8, 256, 128, dtype, seed=3)
    x64, w64 = "fp4_e2m1@block64", "fp4_e2m1@tile64"
    rj = JRecipe(fwd_x=JSpec.from_str(x64), fwd_w=JSpec.from_str(w64))
    rt = TRecipe(fwd_x=TSpec.from_str(x64), fwd_w=TSpec.from_str(w64))
    if packed:
        bj = j_pack(bj, JSpec.from_str("fp4_e2m1@tile128"))
        bt = t_pack(bt, TSpec.from_str("fp4_e2m1@tile128"))
    before = [k.KERNEL.launches for k in (quantize_rows, qmm_stream,
                                          tiled_mm)]
    yt = t_qlinear(at, bt, rt, impl="pallas")
    assert [k.KERNEL.launches for k in (quantize_rows, qmm_stream,
                                        tiled_mm)] == before
    _assert_close(j_qlinear(aj, bj, rj, impl="pallas"), yt, dtype)
