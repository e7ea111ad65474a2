"""The port's analysis layer against the reference's: ``ShapeCell`` /
``SHAPE_CELLS`` / ``list_archs``, ``qdq_scope_name`` and
``scale_logical_axes`` over every spec of ``RECIPES``, the roofline
formulas over every arch x shape cell (the reference's ``HW_V5E`` numbers
passed in as an ``HW`` built here), and qlint: the port's cells for
``tiny`` equal the reference's committed ``tests/qlint_expected_tiny.json``
graph for graph, its whole payload equals
``tests/qlint_expected_tiny_torch.json``, a seeded violation fires, a
block-64 fallback is enumerated with the reference's reason, the
recompile census flags a foreign plan, and the ``qlint_report`` hooks
leave a trainer's state and an engine's cache and slots bitwise as they
were.  Also the QDQ fallback itself on the CPU (the card's is in
``tests/test_torch_kernels_gpu.py``).  All on the CPU at ``tiny`` size;
the reference's qlint runs only where the committed JSON does not
suffice (the fallback cell, traced, not compiled).
"""
import dataclasses
import json
import os
from types import SimpleNamespace

import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from repro.analysis import qlint as j_qlint  # noqa: E402
from repro.analysis import roofline as j_roof  # noqa: E402
from repro.configs import base as j_base  # noqa: E402
from repro.core import quantize as j_quant  # noqa: E402
from repro.core.recipe import RECIPES as J_RECIPES  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro_torch.analysis import qlint, roofline, trace  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.base import TrainConfig, get_config  # noqa: E402
from repro_torch.core import quantize, routing  # noqa: E402
from repro_torch.core.packed import pack_tensor  # noqa: E402
from repro_torch.core.qlinear import dot_qdq, qlinear  # noqa: E402
from repro_torch.core.quantize import BF16_SPEC, QuantSpec  # noqa: E402
from repro_torch.core.recipe import (RECIPES, MatmulRecipe,  # noqa: E402
                                     PrecisionPlan)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.serving_runtime import (  # noqa: E402
    DecodeEngine, quantize_weights_for_serving)
from repro_torch.train.trainer import Trainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402
from torch_dist_workers import torch_threads as torch_threads  # noqa

TESTS = os.path.dirname(os.path.abspath(__file__))
REF_EXPECT = os.path.join(TESTS, "qlint_expected_tiny.json")
PORT_EXPECT = os.path.join(TESTS, "qlint_expected_tiny_torch.json")
GRAPHS = ("train_unroll", "train_scan", "decode_packed")
BLOCK64_REASON = "unsupported_block: block64 (kernel group size is 128)"
# The reference's TPU entry, as numbers: no TPU figure lives in the port.
HW_REF = roofline.HW(j_roof.HW_V5E.name, j_roof.HW_V5E.peak_flops,
                     j_roof.HW_V5E.hbm_bw, j_roof.HW_V5E.link_bw)


def _tcfg(**kw):
    kw.setdefault("recipe", "fine_grained_fp4")
    kw.setdefault("total_steps", 4)
    # 4 x 32 = 128 tokens: the block128 wgrad kernels get a full group
    kw.setdefault("global_batch", 4)
    kw.setdefault("seq_len", 32)
    kw.setdefault("log_every", 0)
    return TrainConfig(**kw)


# ---------------------------------------------------------------------------
# configs, quantize helpers, roofline: bitwise the reference's
# ---------------------------------------------------------------------------

def test_shape_cells_and_archs_match_reference():
    assert [f.name for f in dataclasses.fields(base.ShapeCell)] == \
        [f.name for f in dataclasses.fields(j_base.ShapeCell)]
    assert [dataclasses.astuple(c) for c in base.SHAPE_CELLS] == \
        [dataclasses.astuple(c) for c in j_base.SHAPE_CELLS]
    assert base.list_archs() == j_base.list_archs()
    for arch in base.list_archs():
        get_config(arch)


def _recipe_specs(recipes):
    out = set()
    for r in recipes.values():
        for cls in ("attn_linear", "ffn_linear", "head_linear"):
            mm = getattr(r, cls)
            for f in dataclasses.fields(mm):
                out.add(getattr(mm, f.name).to_str())
    return sorted(out)


def test_qdq_scope_name_and_scale_axes_bitwise():
    specs = _recipe_specs(RECIPES)
    assert specs == _recipe_specs(J_RECIPES) and len(specs) > 5
    for s in specs + ["fp4_e2m1@block64", "fp16", "fp8_e4m3@tile128:pow2"]:
        assert quantize.qdq_scope_name(QuantSpec.from_str(s)) == \
            j_quant.qdq_scope_name(j_quant.QuantSpec.from_str(s)), s
    for gran in ("tensor", "token", "block", "tile"):
        for axis in (0, 1):
            for axes in (("row", "col"), (None, "embed"), ("a", None)):
                assert quantize.scale_logical_axes(gran, axis, axes) == \
                    j_quant.scale_logical_axes(gran, axis, axes)
    with pytest.raises(ValueError):
        quantize.scale_logical_axes("row", 1, ("a", "b"))


@pytest.mark.parametrize("arch", base.list_archs())
def test_roofline_bitwise(arch):
    """model_flops, scan_flop_corrections and roofline_terms over every
    shape cell, on the same active-parameter count (itself equal)."""
    cfg, jcfg = get_config(arch), j_base.get_config(arch)
    n_active = build_model(cfg, "cpu").active_param_count()
    assert n_active == j_build(jcfg).active_param_count()
    for cell, jcell in zip(base.SHAPE_CELLS, j_base.SHAPE_CELLS):
        mf = roofline.model_flops(cfg, cell, n_active)
        assert mf == j_roof.model_flops(jcfg, jcell, n_active)
        for chips in (1, 4):
            corr = roofline.scan_flop_corrections(cfg, cell, chips)
            assert corr == j_roof.scan_flop_corrections(jcfg, jcell, chips)
            kw = dict(hlo_flops=mf / chips * 1.25, hlo_bytes=3.5e11 * chips,
                      collective_bytes_eff=1.5e9, chips=chips,
                      flop_correction=corr["total"], model_flops_total=mf)
            assert roofline.roofline_terms(hw=HW_REF, **kw) == \
                j_roof.roofline_terms(hw=j_roof.HW_V5E, **kw)
    assert roofline.HW_H100.peak_flops == 989e12
    assert roofline.HW_H100.hbm_bw == 3.35e12


# ---------------------------------------------------------------------------
# trace walkers
# ---------------------------------------------------------------------------

def test_trace_walkers():
    assert trace.shape_bytes("bfloat16", (4, 3)) == 24
    assert trace.shape_bytes("float32", ()) == 4
    assert trace.shape_bytes("nope", (2,)) == 0
    calls = [routing.KernelCall("tiled_mm", "fwd", "L0",
                                (("bfloat16", (8, 8)), ("float32", (8, 8))),
                                "cpu"),
             routing.KernelCall("flash_attention", None, "L0",
                                (("float32", (2, 8, 16)),), "cpu"),
             routing.KernelCall("quantize_rows", "wgrad", None,
                                (("float32", (8,)),), "cpu")]
    assert trace.kernel_census(calls) == {"fwd": 1, "-": 1, "wgrad": 1}
    wide = trace.wide_operands(calls, "bfloat16")
    assert len(wide) == 2 and wide[0].startswith("qrole_fwd: float32")
    assert trace.wide_operands(calls, "float32") == []

    def ev(name, start, device="DeviceType.CUDA"):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start))
    tc = "void (anonymous namespace)::tiled_mm_tc_kernel<8>(float*, int)"
    prof = SimpleNamespace(events=lambda: [
        ev("qrole_fwd", 0, "DeviceType.CPU"), ev("quantize_tok_kernel", 1),
        ev("void at::native::vectorized_elementwise_kernel<4>(int)", 2),
        ev("col_amax_kernel", 3), ev("quantize_cols_kernel", 4),
        ev(tc, 6), ev("Memcpy DtoD (Device -> Device)", 7),
        ev("flash_fwd_tc_kernel", 8)])

    def call(name, role, launches, device="cuda"):
        return routing.KernelCall(name, role, None, (), device, launches)
    calls = [call("quantize_rows", "dgrad", 1),
             call("quantize_rows", "dgrad", 2),
             call("qmm_stream", "dgrad", 0, "cpu"),
             call("tiled_mm", "dgrad", 1),
             call("flash_attention", None, 1)]
    assert trace.device_kernels(prof) == [
        "quantize_tok_kernel", "col_amax_kernel", "quantize_cols_kernel",
        "tiled_mm_tc_kernel", "flash_fwd_tc_kernel"]
    assert trace.trace_role_ops(prof, calls) == (
        {"dgrad": {"quantize_tok_kernel": 1, "col_amax_kernel": 1,
                   "quantize_cols_kernel": 1, "tiled_mm_tc_kernel": 1},
         "-": {"flash_fwd_tc_kernel": 1}}, 0, 0)
    # one call fewer than the trace has: the rest still match, in order
    # (the two-launch quantize pass takes the first two quantize kernels)
    assert trace.trace_role_ops(prof, calls[1:]) == (
        {"dgrad": {"quantize_tok_kernel": 1, "col_amax_kernel": 1,
                   "tiled_mm_tc_kernel": 1},
         "-": {"flash_fwd_tc_kernel": 1}}, 0, 1)
    # a call whose kernels the trace does not have
    assert trace.trace_role_ops(prof, calls[3:] + [calls[0]])[1:] == (1, 3)


# ---------------------------------------------------------------------------
# the QDQ fallback (CPU; the card's: tests/test_torch_kernels_gpu.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
def test_qdq_fallback_on_cpu(packed):
    """A fp4_e2m1@block64 spec under ``linear_impl="pallas"`` runs
    ``dot_qdq`` (bitwise its values), and the census records
    ``qdq_fallback`` with the reference's reason string."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(8, 256, generator=gen).to(torch.bfloat16)
    w = (torch.randn(256, 128, generator=gen) * 0.05).to(torch.bfloat16)
    spec_w = QuantSpec.from_str("fp4_e2m1@tile128")
    recipe = MatmulRecipe(fwd_x=QuantSpec.from_str("fp4_e2m1@block64"),
                          fwd_w=spec_w)
    if packed:
        w = pack_tensor(w, spec_w)
        want = dot_qdq(x, w.dequantize().to(x.dtype), recipe.fwd_x,
                       BF16_SPEC)
    else:
        want = dot_qdq(x, w, recipe.fwd_x, spec_w)
    with routing.capture(markers=True) as log:
        y = qlinear(x, w, recipe, impl="pallas")
    assert torch.equal(y, want)
    (ev,) = log.cells()
    assert ev.route == "qdq_fallback"
    assert ev.reasons == (f"lhs: {BLOCK64_REASON}",)
    assert log.kernel_calls == []
    assert log.qdq_calls == [("fwd", "qdq_fp4_e2m1_block64")] + (
        [] if packed else [("fwd", "qdq_fp4_e2m1_tile128")])


# ---------------------------------------------------------------------------
# qlint
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_reports():
    return qlint.build_reports("tiny", "fine_grained_fp4", impl="pallas",
                               decode=True, device="cpu")


def test_qlint_cells_match_reference(tiny_reports):
    """Cells graph for graph the reference's committed census; the
    kernel calls: train_unroll's equal the reference's pallas_call
    equations, and the per-layer loop gives the same in the scan layout
    (the reference's scan body counts once: half) and at decode."""
    payload = qlint.expectations_payload(tiny_reports)
    with open(REF_EXPECT) as f:
        ref = json.load(f)
    for g in GRAPHS:
        assert payload["graphs"][g]["cells"] == ref["graphs"][g]["cells"], g
        assert payload["graphs"][g]["qdq_markers"] == \
            ref["graphs"][g]["qdq_markers"] == {}
    calls = {g: payload["graphs"][g]["pallas_calls"] for g in GRAPHS}
    assert calls["train_unroll"] == ref["graphs"]["train_unroll"][
        "pallas_calls"] == calls["train_scan"]
    assert {k: 2 * v for k, v in ref["graphs"]["train_scan"][
        "pallas_calls"].items()} == calls["train_scan"]
    assert {k: 2 * v for k, v in ref["graphs"]["decode_packed"][
        "pallas_calls"].items()} == calls["decode_packed"]
    assert payload["n_violations"] == payload["n_fallbacks"] == 0
    with open(PORT_EXPECT) as f:
        assert payload == json.load(f)


def test_qlint_cli_gate(tiny_reports, monkeypatch, tmp_path, capsys):
    """The CLI's exits: 0 against the committed file, 2 on drift; its
    JSON; ``--mesh`` in a world smaller than the mesh stops with how to
    launch the ranks (the meshed audit itself: test_torch_spmd_train)."""
    monkeypatch.setattr(qlint, "build_reports",
                        lambda *a, **k: tiny_reports)
    argv = ["--config", "tiny", "--plan", "fine_grained_fp4", "--impl",
            "pallas", "--decode", "--device", "cpu"]
    out = tmp_path / "q.json"
    assert qlint.main(argv + ["--expect", PORT_EXPECT,
                              "--json", str(out)]) == 0
    assert "qlint: expectations match" in capsys.readouterr().out
    assert [r["label"] for r in json.loads(out.read_text())["reports"]] \
        == list(GRAPHS)
    drift = tmp_path / "drift.json"
    with open(PORT_EXPECT) as f:
        exp = json.load(f)
    exp["graphs"]["train_scan"]["pallas_calls"]["fwd"] += 1
    drift.write_text(json.dumps(exp))
    assert qlint.main(argv + ["--expect", str(drift)]) == 2
    assert "EXPECTATION DRIFT" in capsys.readouterr().out
    monkeypatch.undo()
    with pytest.raises(SystemExit, match="nproc-per-node 2"):
        qlint.build_reports("tiny", "fine_grained_fp4", mesh=(2, 1),
                            device="cpu")
    census, findings = qlint.audit_comms([], expect_fp8=True)
    assert census["grad_payload_bytes"] == 0
    assert [f.severity for f in findings] == ["violation"]


def test_label_layers_and_scale_placement_match_reference():
    for label, n in (("L3", 8), ("L0:2:1", 8), ("L1:8:4", 8),
                     ("L0:16:8", 12), (None, 8)):
        assert qlint._label_layers(label, n) == \
            j_qlint._label_layers(label, n)
    for name in ("fine_grained_fp4", "paper_fp4", "fp8", "bf16"):
        plan = PrecisionPlan.uniform(RECIPES[name], 2)
        assert qlint.audit_scale_placement(plan) == []


def test_seeded_violation_fails_the_gate():
    """Run fine_grained_fp4 (quantized dgrad) but audit against the
    paper's protected plan: the role-safety check catches the quantize
    on the BF16-protected dgrad path (the reference's test)."""
    cfg = get_config("tiny").replace(scan_layers=False)
    protected = PrecisionPlan.uniform(RECIPES["paper_fp4"], cfg.n_layers)
    assert protected.layer(0).for_class("ffn").dgrad_g.is_passthrough
    report = qlint.audit_train_graph(cfg, _tcfg(), label="seeded",
                                     plan=protected, device="cpu")
    viols = report.violations()
    assert any(f.check == "role_safety" and "protected" in f.message
               and "dgrad" in f.where for f in viols)
    assert not report.ok
    assert qlint.expectations_payload([report])["n_violations"] > 0
    # the qdq impl marks its quantizes under the roles
    assert report.summary["qdq_markers"]
    assert report.summary["pallas_calls"] == {}


def test_fallback_cell_is_enumerated_with_reason(monkeypatch):
    """A block-64 FFN forward falls back to QDQ: a fallback finding with
    the structured reason, not a violation; its cells equal the
    reference's traced census for the same recipe."""
    odd = {}
    for pkg, recipes in (("port", RECIPES), ("ref", J_RECIPES)):
        b = recipes["fine_grained_fp4"]
        spec = type(b.ffn_linear.fwd_x)
        odd[pkg] = dataclasses.replace(
            b, name="odd_block_test", ffn_linear=dataclasses.replace(
                b.ffn_linear, fwd_x=spec("fp4_e2m1", "block", block=64),
                fwd_w=spec("fp4_e2m1", "block", block=64)))
        monkeypatch.setitem(recipes, "odd_block_test", odd[pkg])
    cfg = get_config("tiny").replace(scan_layers=False, linear_impl="pallas")
    report = qlint.audit_train_graph(cfg, _tcfg(recipe="odd_block_test"),
                                     label="odd", device="cpu")
    falls = report.fallbacks()
    assert falls and all(BLOCK64_REASON in f.message for f in falls)
    assert report.violations() == []
    jcfg = j_base.get_config("tiny").replace(scan_layers=False,
                                             linear_impl="pallas")
    jtcfg = j_base.TrainConfig(recipe="odd_block_test", total_steps=4,
                               global_batch=4, seq_len=32, log_every=0)
    jrep = j_qlint.audit_train_graph(jcfg, jtcfg, label="odd",
                                     compile_hlo=False)
    assert qlint.expectations_payload([report])["graphs"]["odd"]["cells"] \
        == j_qlint.expectations_payload([jrep])["graphs"]["odd"]["cells"]
    assert [f.to_dict() for f in report.fallbacks()] == \
        [f.to_dict() for f in jrep.fallbacks()]


def test_recompile_census_flags_foreign_plan():
    cfg = get_config("tiny").replace(scan_layers=True)
    trainer = Trainer(build_model(cfg, "cpu"), _tcfg(), pipeline=None)
    trainer._step_fn(trainer.plan)
    census, findings = qlint.recompile_census(trainer)
    assert findings == [] and census["n_compiled"] == 1
    trainer._step_fn(PrecisionPlan.uniform(RECIPES["bf16"], cfg.n_layers))
    census, findings = qlint.recompile_census(trainer)
    assert any(f.check == "recompile" for f in findings)
    assert census["n_compiled"] == len(census["keys"]) == 2


def _snapshot(tree):
    return [t.clone() for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _same(a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_trainer_qlint_report_leaves_state_unchanged():
    from repro_torch.data import SyntheticLM
    cfg = get_config("tiny").replace(dtype="float32", linear_impl="pallas")
    tcfg = _tcfg()
    trainer = Trainer(build_model(cfg, "cpu"), tcfg,
                      SyntheticLM(cfg.vocab_size, tcfg.seq_len,
                                  tcfg.global_batch))
    state = trainer.train(num_steps=1)
    before = (_snapshot(state.params), _snapshot(state.opt_state),
              state.step, [dict(r) for r in trainer.history])
    report = trainer.qlint_report()
    assert report.violations() == [] and report.fallbacks() == []
    census = report.summary["recompile"]
    assert census["n_compiled"] <= census["budget"]
    after = (_snapshot(state.params), _snapshot(state.opt_state),
             state.step, trainer.history)
    assert _same(before[0], after[0]) and _same(before[1], after[1])
    assert before[2:] == after[2:]
    assert all(not p.requires_grad for p in tree_leaves(state.params))


def test_engine_qlint_report_leaves_cache_and_slots_unchanged():
    cfg = get_config("tiny").replace(linear_impl="pallas")
    model = build_model(cfg, "cpu")
    qparams = quantize_weights_for_serving(model, model.init(0), "fp4_e2m1",
                                           device="cpu")
    engine = DecodeEngine(model, qparams, n_slots=2, max_len=32,
                          recipe=RECIPES["fine_grained_fp4"],
                          kv_format="fp8_e4m3", device="cpu")
    tok, c1 = engine.prefill([3, 1, 4, 1, 5])
    engine.insert(c1, tok, 1)
    engine.generate_step()
    before = (_snapshot(engine.cache), engine.live.copy(),
              engine.lengths.copy(), engine.last_tok.copy(),
              engine.last_logits.clone())
    report = engine.qlint_report()
    assert report.violations() == [] and report.fallbacks() == []
    routes = {(c["cls"], c["role"]): c["route"] for c in report.cells}
    assert routes[("head", "fwd")] == "dot"
    assert routes[("ffn", "fwd")] == "pallas"
    assert report.summary["pallas_calls"] == {"fwd": 22}
    assert report.summary["recompile"]["captures"] == {
        "prefill": 0, "insert": 0, "generate": 0}
    assert _same(before[0], _snapshot(engine.cache))
    assert (before[1] == engine.live).all()
    assert (before[2] == engine.lengths).all()
    assert (before[3] == engine.last_tok).all()
    assert torch.equal(before[4], engine.last_logits)
