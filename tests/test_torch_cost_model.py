"""The port's cost model (``repro_torch.core.cost_model``) against the
reference's, on the CPU.

Bar: bitwise ``==``.  Every price is a Python float computed by the same
operations in the same order, so ``plan_cost``, ``schedule_cost`` (with
and without ``total_steps``), ``theoretical_cost``,
``schedule_adjusted_cost``, ``paper_calibrated_cost`` and
``compute_share`` must equal the reference's exactly: for every recipe of
``RECIPES`` as a uniform, ``first_last_k`` and ``ramp`` plan and as
promoted / demoted plans, on ``tiny``, gpt2-125m and llama-1b dims, with
and without a measured calibration.  Either package reads the other's
``speed_factors.v1`` file and prices equal; lookup order and errors are
the reference's.
"""
import dataclasses
import importlib
import json

import pytest

pytest.importorskip("jax")

from repro.core import cost_model as jc  # noqa: E402
from repro.core.recipe import PrecisionPlan as JPlan  # noqa: E402
from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro_torch.core import cost_model as tc  # noqa: E402
from repro_torch.core.recipe import PrecisionPlan  # noqa: E402
from repro_torch.core.recipe import RECIPES  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

ARCHS = {"tiny": 64, "gpt2-125m": 1024, "llama-1b": 2048}
# A measured-looking table: exact, swapped, format-only and missing keys,
# so every branch of CostCalibration.lookup prices some role.
TABLE = {("fp4_e2m1@block", "fp4_e2m1@tile"): 0.0557,
         ("fp8_e4m3@token", "fp8_e4m3@token"): 0.231,
         ("fp8_e4m3@token", "fp8_e5m2@token"): 0.244,
         ("fp8_e4m3@token", "fp8_e5m2@block"): 0.031,
         ("fp8_e5m2", "fp8_e4m3"): 0.27,
         ("fp4_e2m1", "fp4_e2m1"): 0.0491,
         ("bf16", "bf16"): 0.394}
BLOCKS = [dict(d_model=4096, d_ff=11008, n_heads=32, n_kv_heads=32,
               head_dim=128, seq_len=4096, n_ff_matmuls=3),
          dict(d_model=768, d_ff=3072, n_heads=12, n_kv_heads=12,
               head_dim=64, seq_len=2048, n_ff_matmuls=2),
          dict(d_model=1280, d_ff=3392, n_heads=20, n_kv_heads=4,
               head_dim=64, seq_len=2048, n_ff_matmuls=3, moe_top_k=2)]


def _dims(arch):
    cfg = (importlib.import_module("repro.configs." + arch.replace("-", "_"))
           .CONFIG, importlib.import_module(
               "repro_torch.configs." + arch.replace("-", "_")).CONFIG)
    j = jc.ModelDims.from_config(cfg[0], seq_len=ARCHS[arch])
    t = tc.ModelDims.from_config(cfg[1], seq_len=ARCHS[arch])
    return j, t


def _rows(dims):
    """Per-layer dims as tuples, with each value's type (the classes of
    the two packages never compare equal)."""
    return [tuple((type(v), v) for v in dataclasses.astuple(ld))
            for ld in dims.layers]


def _plans(name, n):
    """(reference plan, the port's from its dict) pairs: uniform,
    first_last_k, ramp, and uniform with a promoted and a demoted cell
    (and a promoted class)."""
    r = J_RECIPES[name]
    u = JPlan.uniform(r, n)
    out = [u, JPlan.first_last_k(r, n, k=min(2, n // 2)),
           JPlan.ramp(r, n, frac=0.5), u.promote("ffn", layer=n - 1),
           u.demote("attn", layer=0), u.promote("attn"),
           u.promote("ffn", layer=0).demote("ffn", layer=n - 1)]
    return [(p, PrecisionPlan.from_dict(p.to_dict())) for p in out]


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("name", sorted(J_RECIPES))
def test_plan_prices_bitwise(name, arch):
    jd, td = _dims(arch)
    assert _rows(td) == _rows(jd) and td.head_flops == jd.head_flops
    assert td.total_fwd_flops == jd.total_fwd_flops
    jcal, tcal = jc.calibrate(TABLE, "t"), tc.calibrate(TABLE, "t")
    for jp, tp in _plans(name, jd.n_layers):
        assert tp.name == jp.name
        for jcal_, tcal_ in ((None, None), (jcal, tcal)):
            assert tc.plan_cost(tp, td, tcal_) == \
                jc.plan_cost(jp, jd, jcal_), (jp.name, jcal_)
            for total in (None, 200, 12, 7):
                assert tc.schedule_cost(
                    tp, td, total_steps=total, calibration=tcal_) == \
                    jc.schedule_cost(jp, jd, total_steps=total,
                                     calibration=jcal_), (jp.name, total)
            assert tc.schedule_cost(
                tp, td, target=PrecisionPlan.from_dict(
                    JPlan.uniform(J_RECIPES["fp8"], jd.n_layers).to_dict()),
                calibration=tcal_) == jc.schedule_cost(
                    jp, jd, target=JPlan.uniform(J_RECIPES["fp8"],
                                                 jd.n_layers),
                    calibration=jcal_)
        assert tc.paper_calibrated_cost(tp) == jc.paper_calibrated_cost(jp)
    # the recipe template itself (uniform of any depth)
    assert tc.plan_cost(RECIPES[name], td) == jc.plan_cost(J_RECIPES[name],
                                                           jd)
    assert tc.paper_calibrated_cost(RECIPES[name]) == \
        jc.paper_calibrated_cost(J_RECIPES[name])


@pytest.mark.parametrize("block", range(len(BLOCKS)))
def test_block_prices_bitwise(block):
    jb, tb = jc.BlockDims(**BLOCKS[block]), tc.BlockDims(**BLOCKS[block])
    assert tc.block_flops(tb) == jc.block_flops(jb)
    assert tc.compute_share(tb) == jc.compute_share(jb)
    assert _rows(tc.ModelDims.from_block(tb, 5)) == \
        _rows(jc.ModelDims.from_block(jb, 5))
    for name in sorted(J_RECIPES):
        for j, t in ((J_RECIPES[name], RECIPES[name]),
                     (JPlan.ramp(J_RECIPES[name], 6), PrecisionPlan.ramp(
                         RECIPES[name], 6))):
            assert tc.theoretical_cost(t, tb) == jc.theoretical_cost(j, jb)
            assert tc.schedule_adjusted_cost(t, tb) == \
                jc.schedule_adjusted_cost(j, jb)


def test_calibration_files_cross_read(tmp_path):
    """Each package writes the same ``speed_factors.v1`` file for a table,
    reads the other's, and prices equal with it."""
    pj, pt = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jc.calibrate(TABLE, source="card").to_json(pj)
    tc.calibrate(TABLE, source="card").to_json(pt)
    with open(pj) as a, open(pt) as b:
        assert json.load(a) == json.load(b)
    t_from_j, j_from_t = tc.CostCalibration.from_json(pj), \
        jc.CostCalibration.from_json(pt)
    assert dict(t_from_j.table) == dict(j_from_t.table) == TABLE
    assert t_from_j.source == j_from_t.source == "card"
    jd, td = _dims("gpt2-125m")
    for name in ("paper_fp4", "fine_grained_fp4", "fp8", "bf16"):
        jp = JPlan.first_last_k(J_RECIPES[name], jd.n_layers, k=2)
        tp = PrecisionPlan.from_dict(jp.to_dict())
        assert tc.plan_cost(tp, td, t_from_j) == jc.plan_cost(jp, jd,
                                                              j_from_t)


def test_speed_factor_lookup_order():
    """Exact pair, swapped pair, format-only pair, then the paper factor —
    the reference's order, on both packages."""
    for mod, recipes in ((tc, RECIPES), (jc, J_RECIPES)):
        fp4, bf = recipes["all_fp4"].ffn_linear, recipes["bf16"].ffn_linear
        a, b = mod._cal_key(fp4.fwd_x), mod._cal_key(fp4.fwd_w)
        assert (a, b) == ("fp4_e2m1@block", "fp4_e2m1@tile")
        assert mod._cal_key(bf.fwd_x) == "bf16"
        assert mod.speed_factor(fp4.fwd_x, fp4.fwd_w) == 4.0
        for table, want in (({(a, b): 0.25, (b, a): 0.3}, 0.25),
                            ({(b, a): 0.3, ("fp4_e2m1",) * 2: 0.4}, 0.3),
                            ({("fp4_e2m1",) * 2: 0.4}, 0.4), ({}, 4.0)):
            cal = mod.calibrate(table)
            assert mod.speed_factor(fp4.fwd_x, fp4.fwd_w, cal) == want
            assert mod.speed_factor(bf.fwd_x, bf.fwd_w, cal) == 1.0
        assert mod.calibrate({"x|y": "2"}).table == {("x", "y"): 2.0}


@pytest.mark.parametrize("bad", ["depth", "type"])
def test_errors_match_reference(bad):
    """A depth mismatch raises ValueError and a non-plan TypeError, with
    the reference's messages."""
    jd, td = _dims("tiny")
    errors = []
    for mod, plans, recipes, dims in ((jc, JPlan, J_RECIPES, jd),
                                      (tc, PrecisionPlan, RECIPES, td)):
        arg = (plans.uniform(recipes["paper_fp4"], 3) if bad == "depth"
               else "paper_fp4")
        with pytest.raises((ValueError, TypeError)) as e:
            mod.plan_cost(arg, dims)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]
