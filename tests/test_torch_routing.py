"""The port's routing census (``core.routing``) against the reference's.

One training step of ``tiny`` (2 layers; 4 for ``first_last_k``) is run
in the port under ``routing.capture()`` and traced in the reference
(``jax.make_jaxpr`` of its step, unrolled: ``scan_layers=False``), both
with remat on.  The deduped census, ``RoutingLog.to_dict()["cells"]``,
must be the same set of events: every (layer, class, role) cell with its
route, spec strings, kernel modes, resolved pipeline, armed SR and
fallback reasons.  The same for one batched decode step of the
packed-weight engine, where a passthrough activation takes
``packed_dot``.

On the CPU autograd runs the backward on the caller's thread, so these
tests cannot show whether dgrad / wgrad events survive a backward on
autograd's own thread, as on the card; ``chip_smoke.py``'s
``train_adaptive`` phase gates that (every step's census holds fwd,
dgrad and wgrad events for all 12 layers of gpt2-125m).
"""
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import routing as j_routing  # noqa: E402
from repro.core.recipe import PrecisionPlan as JPlan  # noqa: E402
from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.train import train_step as j_step  # noqa: E402
from repro.train.serving_runtime import DecodeEngine as JEngine  # noqa: E402
from repro.train.serving_runtime import (  # noqa: E402
    quantize_weights_for_serving as j_quantize)
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import routing  # noqa: E402
from repro_torch.core.recipe import PrecisionPlan  # noqa: E402
from repro_torch.core.recipe import RECIPES  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.train.serving_runtime import (  # noqa: E402
    DecodeEngine, quantize_weights_for_serving)
from repro_torch.train.train_step import make_optimizer  # noqa: E402
from repro_torch.train.train_step import make_train_step  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

SEQ, BATCH = 64, 2


def _cfgs(n_layers=2, **over):
    kw = {**dict(dtype="float32", linear_impl="pallas",
                 attention_impl="pallas", scan_layers=False,
                 n_layers=n_layers), **over}
    return (importlib.import_module("repro.configs.tiny").CONFIG.replace(
        **kw), importlib.import_module("repro_torch.configs.tiny").CONFIG
        .replace(**kw))


def _plan(kind, n_layers):
    """The same plan in both packages (the port's from the reference's
    dict): ``uniform:<recipe>``, ``flk:<recipe>`` (first_last_k, k = 1)
    or ``fallback`` (paper_fp4 with a 32-wide FFN forward block the
    kernels cannot run)."""
    how, _, name = kind.partition(":")
    if how == "flk":
        jp = JPlan.first_last_k(J_RECIPES[name], n_layers, k=1)
    else:
        jp = JPlan.uniform(J_RECIPES[name or "paper_fp4"], n_layers)
    d = jp.to_dict()
    if how == "fallback":
        for row in d["rows"]:
            row["ffn"]["fwd_x"] = "fp4_e2m1@block32"
        jp = JPlan.from_dict(d)
    tp = PrecisionPlan.from_dict(d)
    assert tp.to_dict() == jp.to_dict()
    return jp, tp


def _cells(log):
    return sorted(log.to_dict()["cells"], key=repr)


def _batch(vocab):
    toks = np.random.default_rng(0).integers(0, vocab, (BATCH, SEQ + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("kind,impl,n_layers", [
    ("uniform:paper_fp4", "pallas", 2),
    ("flk:paper_fp4", "pallas", 4),
    ("uniform:fine_grained_fp4", "pallas", 2),
    ("uniform:paper_fp4", "qdq", 2),
    ("fallback", "pallas", 2),
])
def test_train_step_census_matches_reference(kind, impl, n_layers):
    """Census of one training step: equal cell sets, with dgrad and wgrad
    events present for every layer and class; under fine_grained_fp4
    the FFN wgrad arms SR on its gradient operand (``sr_b``)."""
    jcfg, tcfg = _cfgs(n_layers, linear_impl=impl)
    jp, tp = _plan(kind, n_layers)
    batch = _batch(tcfg.vocab_size)
    j_tcfg = JTrainConfig(total_steps=8, global_batch=BATCH, seq_len=SEQ)
    jm = j_build(jcfg)
    params = jm.init(jax.random.PRNGKey(0), jnp.float32)
    opt_state = j_step.make_optimizer(jm, j_tcfg).init(params)
    fn = j_step.make_train_step(jm, j_tcfg, jp, jit=False, donate=False)
    with j_routing.capture() as jlog:
        jax.make_jaxpr(fn)(params, opt_state, jnp.zeros((), jnp.float32),
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           jnp.zeros((), jnp.int32),
                           jnp.ones((), jnp.float32))
    tm = t_build(tcfg, "cpu")
    tparams = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    t_tcfg = TrainConfig(total_steps=8, global_batch=BATCH, seq_len=SEQ)
    step = make_train_step(tm, t_tcfg, tp)
    with routing.capture() as tlog:
        step(tparams, make_optimizer(tm, t_tcfg).init(tparams), None,
             {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    got, want = _cells(tlog), _cells(jlog)
    assert got == want
    roles = {(c["layer"], c["cls"], c["role"]) for c in got}
    assert roles >= {(f"L{i}", cls, role) for i in range(n_layers)
                     for cls in ("attn", "ffn")
                     for role in ("fwd", "dgrad", "wgrad")}
    assert ("L0", "ffn", "wgrad") in roles
    routes = {c["route"] for c in got}
    assert routes == {{"pallas": "pallas", "qdq": "qdq"}[impl], "dot"} | (
        {"qdq_fallback"} if kind == "fallback" else set())
    if kind == "uniform:fine_grained_fp4":
        assert {c["sr_b"] for c in got if c["cls"] == "ffn"
                and c["role"] == "wgrad"} == {True}
    if kind == "fallback":
        fb = [c for c in got if c["route"] == "qdq_fallback"]
        assert fb and all(c["reasons"] == ["lhs: unsupported_block: block32 "
                                           "(kernel group size is 128)"]
                          for c in fb)


@pytest.mark.parametrize("recipe", ["bf16", "paper_fp4"])
def test_decode_step_census_matches_reference(recipe):
    """One batched decode step of the packed-fp4 engine: a passthrough
    activation takes ``packed_dot``, a quantized one the fused route with
    the panel as a pass operand."""
    jcfg, tcfg = _cfgs()
    jm = j_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    je = JEngine(jm, j_quantize(jm, jparams, "fp4_e2m1"), n_slots=2,
                 max_len=32, recipe=J_RECIPES[recipe])
    with j_routing.capture() as jlog:
        jax.make_jaxpr(je._generate_impl)(
            je.params, je.cache, jnp.zeros((2, 1), jnp.int32),
            jnp.zeros((2,), bool))
    tm = t_build(tcfg, "cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    te = DecodeEngine(tm, quantize_weights_for_serving(
        tm, tp, "fp4_e2m1", device="cpu"), n_slots=2, max_len=32,
        recipe=RECIPES[recipe], device="cpu")
    with routing.capture() as tlog:
        te.generate_step()
    got = _cells(tlog)
    assert got == _cells(jlog)
    want_route = "packed_dot" if recipe == "bf16" else "pallas"
    assert {c["route"] for c in got if c["cls"] != "head"} == {want_route}
    assert {c["role"] for c in got} == {"fwd"}


def test_inactive_census_records_nothing():
    """No log installed: no cell, and ``record`` is a no-op."""
    assert routing.active() is None and routing.current_cell() is None
    routing.record("fwd", "dot", "bf16", "bf16")
    with routing.capture() as log, routing.layer_scope("L1"), \
            routing.class_scope("ffn"):
        assert routing.current_cell() == ("L1", "ffn")
        routing.record("fwd", "dot", "bf16", "bf16")
    assert [ev.cell()[:3] for ev in log.events] == [("L1", "ffn", "fwd")]
    assert routing.active() is None
