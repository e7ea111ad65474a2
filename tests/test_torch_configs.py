"""The paper's larger dense configs in the port against the JAX
reference, on the CPU: ``gpt2-335m``, ``gpt2-774m`` and ``llama-1b``
(Table 4), the sliding-window ``h2o-danube-3-4b``, and ``llama3.2-3b``
(GQA, tied embeddings), ``nemotron-4-15b`` (squared ReLU, layernorm) and
``granite-34b`` (MQA: one KV head; learned positions).  ``CONFIG`` and ``REDUCED`` equal the reference's field for
field; at ``REDUCED`` size (2 layers, d 64, f32), from the same
parameters and batch, the loss under ``paper_fp4`` within rtol 1e-5 (the
quantizers see equal inputs before any summation-order difference can
flip a rounding) and the loss and every gradient under ``bf16`` within
rtol 1e-4 / atol 1e-6 (f32 summation order alone).  ``relu2`` is
bitwise the reference's.
"""
import dataclasses
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.nn.layers import relu2 as j_relu2  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.recipe import RECIPES as T_RECIPES  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.nn.layers import ACTIVATIONS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

NEW = ("gpt2_335m", "gpt2_774m", "llama_1b", "h2o_danube_3_4b",
       "llama3_2_3b", "nemotron_4_15b", "granite_34b")


# The paper_fp4 loss's rtol where the default 1e-5 does not hold: with
# granite's one KV head its K / V projections are 16 wide, and at that
# width MKL's and XLA's f32 sums differ in their last bits (2.5e-7
# relative; 0 at widths >= 64), which an FP8 rounding downstream turns
# into a grid step (read: 9.4e-5).  Its bf16 loss and gradients hold the
# strict bars.
FP4_LOSS_RTOL = {"granite_34b": 1e-3}


def _modules(name):
    return (importlib.import_module(f"repro.configs.{name}"),
            importlib.import_module(f"repro_torch.configs.{name}"))


@pytest.mark.parametrize("name", NEW)
def test_config_matches_jax(name):
    jm, tm = _modules(name)
    for what in ("CONFIG", "REDUCED"):
        jc, tc = getattr(jm, what), getattr(tm, what)
        assert [f.name for f in dataclasses.fields(tc)] == \
            [f.name for f in dataclasses.fields(jc)]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc), what
    assert get_config(jm.CONFIG.name) == tm.CONFIG
    assert tm.SKIP_CELLS == jm.SKIP_CELLS


@pytest.mark.parametrize("name", NEW)
def test_reduced_loss_and_grads_match_jax(name):
    jm, tm = _modules(name)
    over = dict(dtype="float32", scan_layers=False)
    jcfg, tcfg = jm.REDUCED.replace(**over), tm.REDUCED.replace(**over)
    jmodel, tmodel = j_build(jcfg), t_build(tcfg, "cpu")
    jparams = jmodel.init(jax.random.PRNGKey(3), jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, tcfg.vocab_size, (2, 65)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "targets": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
          "targets": torch.from_numpy(toks[:, 1:].copy())}
    jl = jmodel.loss(jparams, jb, J_RECIPES["paper_fp4"])[0]
    tl = tmodel.loss(tparams, tb, T_RECIPES["paper_fp4"])[0]
    np.testing.assert_allclose(float(tl), float(jl),
                               rtol=FP4_LOSS_RTOL.get(name, 1e-5))
    jl, jg = jax.value_and_grad(
        lambda p: jmodel.loss(p, jb, J_RECIPES["bf16"])[0])(jparams)
    leaves = tree_leaves(tparams)
    for p in leaves:
        p.requires_grad_(True)
    tl = tmodel.loss(tparams, tb, T_RECIPES["bf16"])[0]
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jg), tcfg))
    assert len(want) == len(tg)
    for a, b in zip(tg, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu2_bitwise(dtype):
    """Squared ReLU (nemotron-4's FFN) bit for bit the reference's, in
    f32 and bf16, zeros and negatives included."""
    x = np.random.default_rng(6).standard_normal(4096).astype(np.float32)
    x[:16] = 0.0
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ACTIVATIONS["relu2"](xt).to(torch.float32).numpy()
    want = np.asarray(j_relu2(xj).astype(jnp.float32))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
