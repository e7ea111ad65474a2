"""The port's precision recipes and plans against the JAX reference, on
the CPU.  Plans are integer-exact data, so the bar is bitwise: equal
``to_dict`` (spec strings, row tables, names, the stage-2 fraction),
equal ``short`` strings and equal ``scan_runs`` / ``is_uniform`` /
``is_passthrough``, at 4 layers and at llama-1b's 48.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import recipe as j  # noqa: E402
from repro_torch.core import recipe as t  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

DEPTHS = (4, 48)
RECIPE_NAMES = sorted(j.RECIPES)


def _same(jp, tp):
    assert tp.to_dict() == jp.to_dict()
    assert tp.is_uniform == jp.is_uniform
    assert tp.is_passthrough == jp.is_passthrough
    assert tp.scan_runs(1) == jp.scan_runs(1)
    assert [r.attn_linear.short() for r in tp.layers] == \
        [r.attn_linear.short() for r in jp.layers]
    assert t.PrecisionPlan.from_dict(tp.to_dict()) == tp


@pytest.mark.parametrize("name", RECIPE_NAMES)
def test_named_recipe_matches_jax(name):
    """Every recipe of the Table-2 grid and beyond: each class recipe's
    spec strings and short form, the stage-2 fraction, passthrough."""
    jr, tr = j.named_recipe(name), t.named_recipe(name)
    assert tr.name == jr.name
    assert tr.target_precision_frac == jr.target_precision_frac
    assert tr.is_passthrough == jr.is_passthrough
    for cls in ("attn", "ffn", "head"):
        assert tr.for_class(cls).to_dict() == jr.for_class(cls).to_dict()
        assert tr.for_class(cls).short() == jr.for_class(cls).short()
        assert t.MatmulRecipe.from_dict(jr.for_class(cls).to_dict()) == \
            tr.for_class(cls)
    with pytest.raises(KeyError):
        t.named_recipe("no_such_recipe")


@pytest.mark.parametrize("n", DEPTHS)
@pytest.mark.parametrize("name", RECIPE_NAMES)
def test_depth_presets_match_jax(name, n):
    """``uniform``, ``first_last_k`` (k = 1, 2 and past the middle) and
    ``ramp`` (frac 0, 0.25, 0.5, 1)."""
    jr, tr = j.named_recipe(name), t.named_recipe(name)
    _same(j.PrecisionPlan.uniform(jr, n), t.PrecisionPlan.uniform(tr, n))
    for k in (1, 2, n // 2 + 1):
        _same(j.PrecisionPlan.first_last_k(jr, n, k=k),
              t.PrecisionPlan.first_last_k(tr, n, k=k))
    for frac in (0.0, 0.25, 0.5, 1.0):
        _same(j.PrecisionPlan.ramp(jr, n, frac=frac),
              t.PrecisionPlan.ramp(tr, n, frac=frac))


@pytest.mark.parametrize("n", DEPTHS)
@pytest.mark.parametrize("name", ["paper_fp4", "fine_grained_fp4", "fp8",
                                  "all_fp4", "bf16"])
def test_plan_transforms_match_jax(name, n):
    """``promote`` / ``demote`` of one cell, a whole class and the head
    (default and explicit targets, every role subset, fp4 and fp8),
    chained; ``resize``; ``stage2_plan``; ``layer`` / ``for_class``; the
    same object back when nothing changes."""
    jp = j.PrecisionPlan.first_last_k(j.named_recipe(name), n, k=1)
    tp = t.PrecisionPlan.first_last_k(t.named_recipe(name), n, k=1)
    moves = [("promote", dict(cls="ffn", layer=1)),
             ("promote", dict(cls="attn")),
             ("promote", dict(cls="head")),
             ("demote", dict(cls="ffn", layer=2)),
             ("demote", dict(cls="attn", roles=("fwd", "dgrad", "wgrad"))),
             ("demote", dict(cls="ffn", roles=("wgrad",), fmt="fp8_e5m2")),
             ("demote", dict(cls="head", roles=("fwd",)))]
    for meth, kw in moves:
        jn, tn = getattr(jp, meth)(**kw), getattr(tp, meth)(**kw)
        _same(jn, tn)
        assert (jn is jp) == (tn is tp)
        jp, tp = jn, tn             # chained, as the controller does
    _same(jp.promote("ffn", 0, to=j.MM_FP8), tp.promote("ffn", 0,
                                                        to=t.MM_FP8))
    with pytest.raises(ValueError):
        tp.demote("ffn", roles=("nope",))
    for m in (1, 2, n // 2, 2 * n, n):
        _same(jp.resize(m), tp.resize(m))
    target = t.PrecisionPlan.uniform(t.RECIPES["bf16"], n)
    _same(j.stage2_plan(jp, j.PrecisionPlan.uniform(j.RECIPES["bf16"], n)),
          t.stage2_plan(tp, target))
    for i in (0, n - 1):
        assert tp.layer(i).to_dict() == jp.layer(i).to_dict()
        for cls in ("attn", "ffn"):
            assert tp.for_class(cls, i).to_dict() == \
                jp.for_class(cls, i).to_dict()
            assert tp.layer(i).for_class(cls).short() == \
                jp.layer(i).for_class(cls).short()
    assert tp.for_class("head").to_dict() == jp.for_class("head").to_dict()
    with pytest.raises(ValueError):
        tp.for_class("ffn")


def test_scan_runs_match_jax():
    """``scan_runs`` over periods 1, 2 and 4 of graded plans."""
    for jp, tp in ((j.PrecisionPlan.first_last_k(j.RECIPES["paper_fp4"], 8,
                                                 k=2),
                    t.PrecisionPlan.first_last_k(t.RECIPES["paper_fp4"], 8,
                                                 k=2)),
                   (j.PrecisionPlan.ramp(j.RECIPES["all_fp4"], 8, 0.75),
                    t.PrecisionPlan.ramp(t.RECIPES["all_fp4"], 8, 0.75))):
        for period in (1, 2, 4):
            assert tp.scan_runs(period) == jp.scan_runs(period)
    assert np.array_equal(
        [len(t.PrecisionPlan.uniform(t.RECIPES["fp8"], 8).scan_runs(1))],
        [1])
