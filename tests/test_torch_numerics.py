"""The port's numerics core against the JAX reference, bitwise.

Inputs come from numpy (``default_rng``) and go through both packages:
format grids, round-to-nearest QDQ in f32 and bf16, the quantize-pass
panels (JAX: Pallas in interpret mode), packed codes and scales, the FP8
KV codec, configs, spec strings and plan dicts, and the layer math.
"""
import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from test_rounding import _boundary_grid  # noqa: E402

from repro.core import formats as j_formats  # noqa: E402
from repro.core import packed as j_packed  # noqa: E402
from repro.core import quantize as j_quant  # noqa: E402
from repro.core import recipe as j_recipe  # noqa: E402
from repro.kernels import rounding as j_rounding  # noqa: E402
from repro.nn import layers as j_layers  # noqa: E402
from repro_torch.core import formats as t_formats  # noqa: E402
from repro_torch.core import packed as t_packed  # noqa: E402
from repro_torch.core import quantize as t_quant  # noqa: E402
from repro_torch.core import recipe as t_recipe  # noqa: E402
from repro_torch.kernels import fp4_matmul as t_fm  # noqa: E402
from repro_torch.kernels import rounding as t_rounding  # noqa: E402
from repro_torch.nn import layers as t_layers  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

j_fm = importlib.import_module("repro.kernels.fp4_matmul")

FMTS = ("fp4_e2m1", "fp8_e4m3")
DTYPES = ("float32", "bfloat16")
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(getattr(jnp, dtype)),
            torch.from_numpy(np.asarray(x, np.float32)).to(T_DT[dtype]))


def _assert_bitwise(j, t):
    a = np.asarray(jnp.asarray(j).astype(jnp.float32))
    b = t.to(torch.float32).numpy()
    assert a.shape == b.shape
    assert a.tobytes() == b.tobytes(), int((a != b).sum())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FMTS)
def test_rounding_bitwise_on_boundary_grids(fmt, dtype):
    """round_to_format and round_to_grid on the exponent-boundary grids
    of tests/test_rounding.py (-0.0 included)."""
    vals = np.concatenate([_boundary_grid(j_formats.FORMATS[fmt]),
                           np.float32([-0.0])])
    xj, xt = _both(vals, dtype)
    jf, tf = j_formats.FORMATS[fmt], t_formats.FORMATS[fmt]
    _assert_bitwise(j_formats.round_to_format(xj, jf),
                    t_formats.round_to_format(xt, tf))
    _assert_bitwise(j_rounding.round_to_grid(xj, jf),
                    t_rounding.round_to_grid(xt, tf))


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_tile_bitwise(dtype):
    """The in-kernel group QDQ helper, per-row and whole-tile scales."""
    x = np.random.default_rng(6).standard_normal((128, 128)) * 4
    x[3] = 0
    xj, xt = _both(x.astype(np.float32), dtype)
    for fmt in FMTS:
        for per_row in (True, False):
            _assert_bitwise(
                j_rounding.quantize_tile(xj, j_formats.FORMATS[fmt],
                                         per_row=per_row),
                t_rounding.quantize_tile(xt, t_formats.FORMATS[fmt],
                                         per_row=per_row))


def test_format_values_and_pow2_floor():
    for fmt in FMTS:
        assert (t_formats.format_values_host(t_formats.FORMATS[fmt])
                == j_formats.format_values_host(j_formats.FORMATS[fmt]))
    s = np.exp(np.random.default_rng(1).uniform(-40, 10, 4096)
               ).astype(np.float32)
    _assert_bitwise(j_quant.pow2_floor(jnp.asarray(s)),
                    t_quant.pow2_floor(torch.from_numpy(s)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("gran", ["tensor", "token", "block", "tile"])
def test_qdq_bitwise(gran, fmt, dtype):
    """QDQ per granularity on both reduction axes (pow2 scales on axis 0),
    odd shape, a zero row (eps-floored scale)."""
    x = np.random.default_rng(2).standard_normal((130, 200)) * 3
    x[5] = 0
    xj, xt = _both(x.astype(np.float32), dtype)
    for axis, pow2 in ((1, False), (0, True)):
        _assert_bitwise(
            j_quant.qdq(xj, j_quant.QuantSpec(fmt, gran, 128,
                                              pow2_scale=pow2), axis),
            t_quant.qdq(xt, t_quant.QuantSpec(fmt, gran, 128,
                                              pow2_scale=pow2), axis))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode,fmt", [("token", "fp8_e4m3"),
                                      ("block", "fp4_e2m1")])
def test_quantize_panels_bitwise(mode, fmt, dtype):
    """The quantize pass's panel: JAX Pallas kernel (interpret mode) vs
    the port's quantize_panels (plain version on the CPU)."""
    x = np.random.default_rng(3).standard_normal((256, 768)) * 2
    x[7] = 0
    xj, xt = _both(x.astype(np.float32), dtype)
    _assert_bitwise(j_fm.quantize_panels(xj, mode=mode, fmt_name=fmt),
                    t_fm.quantize_panels(xt, mode=mode, fmt_name=fmt))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fmt", FMTS)
def test_pack_tensor_and_kv_codec_bitwise(fmt, dtype):
    rng = np.random.default_rng(4)
    w = (rng.standard_normal((3, 200, 77)) * 2).astype(np.float32)
    wj, wt = _both(w, dtype)
    jp = j_packed.pack_tensor(wj, j_quant.QuantSpec(fmt, "tile", 128))
    tp = t_packed.pack_tensor(wt, t_quant.QuantSpec(fmt, "tile", 128))
    assert np.array_equal(np.asarray(jp.payload), tp.payload.numpy())
    _assert_bitwise(jp.scale, tp.scale)
    _assert_bitwise(jp.dequantize(), tp.dequantize())
    assert tp.nbytes == jp.nbytes
    kv = (rng.standard_normal((2, 9, 3, 16)) * 5).astype(np.float32)
    kv[0, 1] = 0
    kj, kt = _both(kv, dtype)
    if fmt == "fp8_e4m3":
        jc, js = j_packed.kv_quantize(kj, fmt)
        tc, ts = t_packed.kv_quantize(kt, fmt)
        assert np.array_equal(np.asarray(jc), tc.numpy())
        _assert_bitwise(js, ts)
        _assert_bitwise(j_packed.kv_dequantize(jc, js, fmt, kj.dtype),
                        t_packed.kv_dequantize(tc, ts, fmt, kt.dtype))


@pytest.mark.parametrize("arch", ["gpt2_125m", "llama_125m", "tiny"])
def test_configs_match(arch):
    j = importlib.import_module(f"repro.configs.{arch}")
    t = importlib.import_module(f"repro_torch.configs.{arch}")
    for name in ("CONFIG", "REDUCED"):
        assert (dataclasses.asdict(getattr(j, name))
                == dataclasses.asdict(getattr(t, name)))


def test_spec_strings_and_plans_match():
    for s in ("bf16", "fp8_e4m3@token", "fp4_e2m1@block128",
              "fp4_e2m1@tile128:pow2", "fp8_e5m2@tensor:sr"):
        assert (t_quant.QuantSpec.from_str(s).to_str()
                == j_quant.QuantSpec.from_str(s).to_str() == s)
    for name in ("bf16", "fp8", "paper_fp4"):
        for depth in (1, 2, 12):
            jp = j_recipe.PrecisionPlan.uniform(j_recipe.RECIPES[name],
                                                depth)
            tp = t_recipe.as_plan(t_recipe.RECIPES[name], depth)
            assert tp.to_dict() == jp.to_dict()


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_math(dtype):
    """Norms, activations and RoPE against the reference run op by op:
    bitwise in bf16; in f32 within rtol/atol 1e-6, since f32 reductions
    (mean) and transcendentals (tanh, exp, rsqrt) differ in the last bit
    between XLA and PyTorch (measured <= 6e-7 absolute)."""
    rng = np.random.default_rng(5)
    xj, xt = _both(rng.standard_normal((2, 16, 64)).astype(np.float32) * 3,
                   dtype)
    sc = (rng.standard_normal(64) * 0.1).astype(np.float32)
    sj, st = jnp.asarray(sc), torch.from_numpy(sc)
    q = xj.reshape(2, 16, 4, 16), xt.reshape(2, 16, 4, 16)
    pos = np.arange(3, 19, dtype=np.int32)
    pairs = [
        (j_layers.rms_norm(xj, sj), t_layers.rms_norm(xt, st)),
        (j_layers.layer_norm(xj, sj, sj), t_layers.layer_norm(xt, st, st)),
        (j_layers.gelu(xj), t_layers.gelu(xt)),
        (j_layers.silu(xj), t_layers.silu(xt)),
        (j_layers.rope(q[0], jnp.asarray(pos), 10000.0),
         t_layers.rope(q[1], torch.from_numpy(pos), 10000.0)),
    ]
    for j, t in pairs:
        if dtype == "bfloat16":
            _assert_bitwise(j, t)
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       rtol=1e-6, atol=1e-6)
