"""Parity of the port's fp8 error-feedback gradient compression
(``repro_torch.optim.compression``) with the JAX reference.

The reference runs op by op: under ``jax.jit`` XLA rewrites the scale
arithmetic (an ulp off the eager form on some leaves), so the bar is
its eager numerics, as for the port's other bitwise bars.

Bars: bitwise for ``fp8_compress_grads`` (per-tensor RTN QDQ: integer
exact), ``compressed_reduce_dp`` (dp 2, 4, 8; mean and sum) and the
``gloo`` ``compressed_psum`` on 2 and 4 spawned ranks against the
reference's ``jax.vmap(..., axis_name="dp")`` form; the error-feedback
property over 40 steps as the reference's own test states it.
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.optim import compression as jc  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.nn.params import spec_leaves  # noqa: E402
from repro_torch.optim import compression as tc  # noqa: E402

from torch_dist_workers import run_ranks  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa


def _shapes():
    """A leaf of every rank ``tiny`` has (its smallest and largest of each)
    and odd ones (one element, a short row, a 3-D expert stack)."""
    cfg = importlib.import_module("repro_torch.configs.tiny").CONFIG
    by_rank = {}
    for sp in spec_leaves(t_build(cfg, "cpu").param_specs()):
        by_rank.setdefault(len(sp.shape), set()).add(sp.shape)
    shapes = {f(v, key=np.prod) for v in by_rank.values() for f in (min, max)}
    return sorted(shapes | {(1,), (7,), (3, 5, 11)})


def _tree(seed, lead=(), scale_spread=True):
    """{shape name: f32 array}: N(0, 1) times a per-leaf scale spread over
    ten decades (gradients of different layers), plus zeros and a
    leaf of one repeated value."""
    rng = np.random.RandomState(seed)
    out = {}
    for i, shape in enumerate(_shapes()):
        s = 10.0 ** rng.uniform(-6, 3) if scale_spread else 1.0
        out[f"l{i}"] = (rng.randn(*(lead + shape)) * s).astype(np.float32)
    out["zeros"] = np.zeros(lead + (4, 8), np.float32)
    out["flat"] = np.full(lead + (16,), 0.3, np.float32)
    return out


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _eq(got, want, what):
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg=f"{what}[{k}]")


def test_fp8_compress_grads_bitwise():
    g = _tree(0)
    r = {k: (v * 1e-3).astype(np.float32) for k, v in _tree(1).items()}
    jg, jr = jc.fp8_compress_grads(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()})
    tg, tr = tc.fp8_compress_grads(_t(g), _t(r))
    _eq({k: v.numpy() for k, v in tg.items()}, jg, "grads")
    _eq({k: v.numpy() for k, v in tr.items()}, jr, "residuals")
    # bf16 gradients come back in bf16, as there
    b = {"w": jnp.asarray(g["l3"]).astype(jnp.bfloat16)}
    jb, _ = jc.fp8_compress_grads(b, {"w": jnp.zeros(g["l3"].shape)})
    tb, _ = tc.fp8_compress_grads(
        {"w": torch.from_numpy(g["l3"]).to(torch.bfloat16)},
        {"w": torch.zeros(g["l3"].shape)})
    assert tb["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb["w"].float().numpy(),
                                  np.asarray(jb["w"], np.float32))


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("mean", [True, False])
def test_compressed_reduce_dp_bitwise(dp, mean):
    g = _tree(10 + dp, lead=(dp,))
    r = {k: (v * 1e-2).astype(np.float32)
         for k, v in _tree(20 + dp, lead=(dp,)).items()}
    jo, jr = jc.compressed_reduce_dp(
        {k: jnp.asarray(v) for k, v in g.items()},
        {k: jnp.asarray(v) for k, v in r.items()}, mean=mean)
    to, tr = tc.compressed_reduce_dp(_t(g), _t(r), mean=mean)
    _eq({k: v.numpy() for k, v in to.items()}, jo, "reduced")
    _eq({k: v.numpy() for k, v in tr.items()}, jr, "residuals")
    init = tc.init_compression_state(_t(_tree(0)), dp_size=dp)
    assert all(v.shape == (dp,) + _tree(0)[k].shape and not v.any()
               for k, v in init.items())


def test_fp8_sum_is_sequential_and_rounded():
    """The reference's fp8 sum over the replica axis adds in replica
    order with every partial sum rounded to e4m3fn; the port's
    ``_fp8_sum`` does the same, and an f32 sum rounded once differs."""
    rng = np.random.RandomState(3)
    x = (rng.randn(8, 4096) * 40).astype(np.float32)
    q = jnp.asarray(x).astype(jnp.float8_e4m3fn)
    want = np.asarray(jnp.sum(q, axis=0).astype(jnp.float32))
    codes = torch.from_numpy(x).to(torch.float8_e4m3fn)
    np.testing.assert_array_equal(tc._fp8_sum(codes).numpy(), want)
    once = codes.float().sum(0).to(torch.float8_e4m3fn).float().numpy()
    assert (once != want).any()


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_compressed_psum_bitwise(world, tmp_path):
    """``compressed_psum`` on ``world`` spawned gloo ranks equals the
    reference's vmapped ``compressed_psum`` lane for lane, and each rank
    put 1-byte codes on the wire (plus one f32 scale word a leaf)."""
    g = _tree(30 + world, lead=(world,))
    r = {k: (v * 1e-2).astype(np.float32)
         for k, v in _tree(40 + world, lead=(world,)).items()}
    f = jax.vmap(lambda a, b: jc.compressed_psum_grads(a, b, "dp"),
                 axis_name="dp")
    jo, jr = f({k: jnp.asarray(v) for k, v in g.items()},
               {k: jnp.asarray(v) for k, v in r.items()})
    outs = run_ranks("psum_tree", world, tmp_path, g, r)
    for rank, (out, res, census) in enumerate(outs):
        _eq(out, {k: np.asarray(v)[rank] for k, v in jo.items()},
            f"rank {rank} reduced")
        _eq(res, {k: np.asarray(v)[rank] for k, v in jr.items()},
            f"rank {rank} residual")
        codes = [c for c in census if c["tag"] == "grad_codes"]
        scales = [c for c in census if c["tag"] == "scale"]
        assert len(codes) == len(scales) == len(g)
        assert all(c["op"] == "all-gather" and c["dtype"] == "uint8"
                   and c["nbytes"] == int(np.prod(c["shape"]))
                   and c["group_size"] == world for c in codes)
        assert all(c["op"] == "all-reduce" and c["dtype"] == "float32"
                   and c["nbytes"] == 4 and c["reduce_op"] == "max"
                   for c in scales)
    # sum semantics, as the reference's own test states them
    x = np.asarray([[1.0, 2.0], [3.0, 4.0]], np.float32)
    if world == 2:
        s = run_ranks("psum_sum", 2, tmp_path, x)
        for out in s:
            np.testing.assert_allclose(out, [4.0, 6.0], rtol=0.1)


def test_error_feedback_over_40_steps():
    """The reference's error-feedback property on the port's
    ``compressed_reduce_dp``: the time-average of 40 reduced steps beats
    the worst single step by 2x, and the residuals stay bounded; each
    step bitwise the reference's."""
    rng = np.random.RandomState(2)
    g = rng.randn(4, 64).astype(np.float32)
    tr = torch.zeros(4, 64)
    jr = jnp.zeros((4, 64), jnp.float32)
    true_mean = g.astype(np.float64).mean(0)
    acc = np.zeros(64, np.float64)
    errs = []
    for _ in range(40):
        out, tr = tc._reduce_dp_one(torch.from_numpy(g), tr, True)
        jo, jr = jc._reduce_dp_one(jnp.asarray(g), jr, True)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jo))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        acc += out.numpy().astype(np.float64)
        errs.append(float(np.abs(out.numpy() - true_mean).max()))
    assert float(np.abs(acc / 40 - true_mean).max()) < max(errs) / 2
    assert float(tr.abs().max()) < float(np.abs(g).max())
