"""qlint: precision-flow audit of the port's train and decode steps
(counterpart of ``repro.analysis.qlint``).

The reference traces a step (jaxpr and compiled HLO, nothing executes);
the port's steps are eager, so qlint runs one: a training step's forward
and backward on a fresh init (no optimizer step, nothing of a trainer's
state touched) or one batched decode step of an engine on a scratch
copy of its cache, under a marking routing capture
(``core.routing.capture(markers=True)``).  Four check families, as the
reference's:

  * **kernel presence** — every (layer, class, role) cell the plan
    routes through the fused kernels has kernel calls under that role
    (and, on the card, each call's CUDA kernels in a ``torch.profiler``
    trace of the step, in launch order); QDQ fallbacks are enumerated
    with their structured reasons (``core.qlinear.
    kernel_unsupported_reason``);
  * **role safety** — cells a protection preset keeps in BF16 are never
    fed through a quantize (a QDQ marker under a role must be explained
    by the routing census, and every census cell's specs must match the
    plan's resolved cell), stochastic rounding is armed exactly where
    specs say ``:sr``, and no operand wider than ``cfg.dtype`` reaches a
    kernel;
  * **scale placement and comms** — the block / tile quant-scale
    placement table still shards scales with their operand's reduction
    axis (``core.quantize.scale_logical_axes``); a meshed step (``--mesh``,
    run on its ranks) runs whole, optimizer included, and
    ``audit_comms`` reads the collectives it issued
    (``distributed.comms.recording``): under fp8 compression with a data
    axis > 1 every gradient payload must be 1-byte codes, the f32 amax
    reductions are censused apart as scale metadata;
  * **recompile budget** — a census over the trainer's step functions
    (``Trainer._steps``, keyed by plan and telemetry as the reference's
    compiled graphs) flags a plan outside the expected set; for an
    engine, its CUDA-graph captures per stage against one graph per
    prefill bucket and one per other stage.

Three layers must agree: the routing census (what the code *decided*),
the markers (what *ran*: kernel calls and QDQs per role) and the plan
(what was *asked for*).  Counts: the reference counts ``pallas_call``
equations, once per scan body; the port counts kernel calls (one per
wrapper call: a two-pass matmul is three, a fused stream matmul one),
every layer of its loop, a rematerialized forward again.  Cells are the
reference's: under ``scan_layers`` a cell's layer is labelled with the
reference's scan-slice form (``"L0:2:1"``), from the plan's scan runs.

CLI::

    python -m repro_torch.analysis.qlint --config tiny \\
        --plan fine_grained_fp4 --impl pallas --decode \\
        [--device cpu|cuda] [--json F] [--expect F] [--update-expectations]

``--mesh 2,1`` adds a data-parallel fp8 step: launch its ranks with
``torchrun --standalone --nproc-per-node 2 -m repro_torch.analysis.qlint
... --mesh 2,1`` (``gloo`` on ``--device cpu``, NCCL on ``cuda``); rank 0
prints.

``--expect`` compares the normalized findings against a committed
expectations JSON (``tests/qlint_expected_tiny_torch.json`` for
``tiny``); ``--update-expectations`` rewrites that file from the current
audit.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import math
import sys
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.analysis.trace import (collective_bytes, kernel_census,
                                        trace_role_ops, wide_operands)
from repro_torch.core import routing
from repro_torch.core.quantize import (QuantSpec, qdq_scope_name,
                                       scale_logical_axes)
from repro_torch.core.recipe import ROLE_SUBSETS, PrecisionPlan

__all__ = ["Finding", "QlintReport", "graph_census", "audit_cells",
           "audit_graph_vs_census", "audit_scale_placement", "audit_comms",
           "recompile_census", "engine_capture_census",
           "audit_train_graph", "audit_decode_graph", "audit_decode_engine",
           "audit_trainer", "expectations_payload", "compare_expectations",
           "build_reports", "main"]

_TRAIN_ROLES = ("fwd", "dgrad", "wgrad")
# what a recorded collective carries (``comms.CollectiveRecord.tag``)
_GRAD_TAGS = ("grad", "grad_codes")


# ---------------------------------------------------------------------------
# Findings / report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Finding:
    """One audit observation.

    ``severity``: ``violation`` (gate-failing), ``fallback`` (a pallas impl
    cell that took the QDQ path — counted separately because the tiny-
    config gate requires zero of them), or ``info``.
    """
    check: str          # kernel_presence | role_safety | comms | recompile
    severity: str       # violation | fallback | info
    where: str          # cell / op / key identifier
    message: str

    def to_dict(self) -> Dict[str, str]:
        return dataclasses.asdict(self)


class QlintReport:
    """Findings + census for one audited step (or step family)."""

    def __init__(self, label: str):
        self.label = label
        self.cells: List[Dict[str, Any]] = []
        self.summary: Dict[str, Any] = {}
        self.findings: List[Finding] = []

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings: Sequence[Finding]) -> None:
        self.findings.extend(findings)

    def violations(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "violation"]

    def fallbacks(self) -> List[Finding]:
        return [f for f in self.findings if f.severity == "fallback"]

    @property
    def ok(self) -> bool:
        return not self.violations()

    def to_dict(self) -> Dict[str, Any]:
        return {"label": self.label,
                "cells": self.cells,
                "summary": self.summary,
                "findings": [f.to_dict() for f in self.findings],
                "n_violations": len(self.violations()),
                "n_fallbacks": len(self.fallbacks())}

    def human_report(self) -> str:
        out = [f"== qlint: {self.label} =="]
        s = self.summary
        if s:
            out.append("  " + ", ".join(f"{k}={v}" for k, v in s.items()
                                        if not isinstance(v, dict)))
        for c in self.cells:
            bits = [f"{c['layer'] or '-':>8} {c['cls'] or '-':>5}",
                    f"{c['role']:>5} -> {c['route']:<12}",
                    f"{c['spec_a']} | {c['spec_b']}"]
            extras = []
            if c.get("pipeline"):
                extras.append(c["pipeline"])
            if c.get("sr_a") or c.get("sr_b"):
                extras.append("sr=" + ("a" if c["sr_a"] else "")
                              + ("b" if c["sr_b"] else ""))
            if c.get("reasons"):
                extras.append("; ".join(c["reasons"]))
            out.append("  " + "  ".join(bits)
                       + (("  [" + ", ".join(extras) + "]") if extras
                          else ""))
        if not self.findings:
            out.append("  findings: none")
        for f in self.findings:
            out.append(f"  [{f.severity.upper():>9}] {f.check}: "
                       f"{f.where}: {f.message}")
        out.append(f"  => {len(self.violations())} violation(s), "
                   f"{len(self.fallbacks())} fallback(s)")
        return "\n".join(out)


# ---------------------------------------------------------------------------
# The markers' census
# ---------------------------------------------------------------------------

def graph_census(log: routing.RoutingLog,
                 compute_dtype: str = "bfloat16") -> Dict[str, Any]:
    """Census of a marking capture's markers: ``pallas_calls`` (role ->
    kernel calls; ``"-"`` outside a matmul role), ``qdq_markers``
    (``"role/qdq_<spec>"`` -> count; role ``"-"`` for a quantize outside
    any matmul role) and ``f32_kernel_operands`` (matrix operands wider
    than ``compute_dtype`` that reached a kernel)."""
    qdq = Counter((role or "-", marker) for role, marker in log.qdq_calls)
    return {"pallas_calls": kernel_census(log.kernel_calls),
            "qdq_markers": {f"{r}/{m}": c for (r, m), c in qdq.items()},
            "f32_kernel_operands": wide_operands(log.kernel_calls,
                                                 compute_dtype),
            "n_kernel_calls": len(log.kernel_calls)}


def _scan_labels(cfg, plan: PrecisionPlan) -> Dict[str, str]:
    """``{"L<i>": label}``: under ``scan_layers`` the reference runs each
    run of identical plan rows (``plan.scan_runs``) as one scan whose
    body carries ``L{g0*p + j}:{g1*p}:{p}``; the port's loop labels
    every layer ``L<i>``.  Empty for an unrolled config."""
    if not cfg.scan_layers:
        return {}
    p = cfg.scan_period()
    out = {}
    for g0, g1 in plan.scan_runs(p):
        for g in range(g0, g1):
            for j in range(p):
                out[f"L{g * p + j}"] = f"L{g0 * p + j}:{g1 * p}:{p}"
    return out


def _cells(log: routing.RoutingLog, cfg, plan: PrecisionPlan
           ) -> List[routing.RouteEvent]:
    """The log's deduped census, layers in the reference's labels for
    ``cfg``'s layout (``plan``: the plan the step ran)."""
    labels = _scan_labels(cfg, plan)
    if not labels:
        return log.cells()
    relabelled = routing.RoutingLog()
    for ev in log.events:
        relabelled.add(dataclasses.replace(
            ev, layer=labels.get(ev.layer, ev.layer)))
    return relabelled.cells()


# ---------------------------------------------------------------------------
# Census-vs-plan audit (kernel presence + role safety)
# ---------------------------------------------------------------------------

def _label_layers(label: Optional[str], n_layers: int) -> List[int]:
    """Layer indices a census label covers ('L3' -> [3]; the scan-slice
    form 'L1:8:4' -> [1, 5]; None (the lm-head) -> [])."""
    if label is None:
        return []
    body = label[1:]
    parts = body.split(":")
    if len(parts) == 1:
        return [int(parts[0])]
    start, stop, step = (int(p) for p in parts)
    return [i for i in range(start, stop, step) if i < n_layers]


def _role_specs(mm, role: str) -> Tuple[QuantSpec, QuantSpec]:
    sa, sb = ROLE_SUBSETS[role]
    return getattr(mm, sa), getattr(mm, sb)


def _expected_routes(mm, role: str, impl: str, packed: bool
                     ) -> Tuple[str, ...]:
    from repro_torch.core.qlinear import kernel_quant_mode
    if packed:
        if mm.fwd_x.is_passthrough:
            # protected params (lm head, embeddings) are never packed, so
            # a passthrough cell may be a plain dot over the bf16 weight
            return ("packed_dot", "dot")
        if impl in ("pallas", "pallas_two_pass"):
            return (("pallas",) if kernel_quant_mode(mm.fwd_x) is not None
                    else ("qdq_fallback",))
        return ("qdq",)
    if mm.is_passthrough:
        return ("dot",)
    if impl in ("pallas", "pallas_two_pass"):
        sa, sb = _role_specs(mm, role)
        ok = (kernel_quant_mode(sa) is not None
              and kernel_quant_mode(sb) is not None)
        return ("pallas",) if ok else ("qdq_fallback",)
    return ("qdq",)


def audit_cells(cells: Sequence[routing.RouteEvent], plan: PrecisionPlan,
                impl: str, *, roles: Sequence[str] = _TRAIN_ROLES,
                classes: Sequence[str] = ("attn", "ffn"),
                packed: bool = False) -> List[Finding]:
    """Role-safety + kernel-presence audit of the routing census against
    the resolved plan: per census cell, operand specs match the plan's
    (layer, class, role) cell (a quantized spec on a role the plan keeps
    passthrough is the "protected BF16 cell fed through quantize"
    violation), SR armed exactly per spec, the route the one ``impl``
    should take, fallbacks enumerated; every (layer, class) cell of the
    plan seen for every expected role."""
    findings: List[Finding] = []
    n_layers = plan.n_layers
    seen: Dict[Tuple[int, str, str], routing.RouteEvent] = {}
    head_seen = False

    for ev in cells:
        where = f"{ev.layer or 'head'}/{ev.cls or '?'}/{ev.role}"
        if ev.cls is None:
            findings.append(Finding(
                "role_safety", "violation", where,
                "census event with no class attribution — a matmul ran "
                "outside the module scopes"))
            continue
        if ev.cls == "head":
            head_seen = True
            mms = [("head", plan.for_class("head"))]
        else:
            layers = _label_layers(ev.layer, n_layers)
            if not layers:
                findings.append(Finding(
                    "role_safety", "violation", where,
                    f"census event with unparseable layer label "
                    f"{ev.layer!r}"))
                continue
            mms = [(i, plan.layer(i).for_class(ev.cls)) for i in layers]
        for layer_i, mm in mms:
            if isinstance(layer_i, int):
                seen[(layer_i, ev.cls, ev.role)] = ev
            if packed and ev.role == "fwd":
                # serving panel: census rhs is the pre-dequantized operand
                want_a, want_b = mm.fwd_x, None
            else:
                want_a, want_b = _role_specs(mm, ev.role)
            for op, want, got, sr in (("lhs", want_a, ev.spec_a, ev.sr_a),
                                      ("rhs", want_b, ev.spec_b, ev.sr_b)):
                if want is None:
                    continue
                if want.to_str() != got:
                    if want.is_passthrough:
                        msg = (f"protected (passthrough {want.to_str()}) "
                               f"{op} operand fed through quantize as "
                               f"{got}")
                    else:
                        msg = (f"{op} operand spec {got} does not match "
                               f"the plan's {want.to_str()}")
                    findings.append(Finding("role_safety", "violation",
                                            f"{where}:{op}", msg))
                    continue
                if bool(want.stochastic) != bool(sr):
                    msg = ("plan spec says :sr but stochastic rounding is "
                           "not armed (dropped key?)"
                           if want.stochastic else
                           "stochastic rounding armed on a non-:sr spec")
                    findings.append(Finding("role_safety", "violation",
                                            f"{where}:{op}", msg))
            expects = _expected_routes(mm, ev.role, impl, packed)
            if ev.route not in expects:
                want = (repr(expects[0]) if len(expects) == 1
                        else f"one of {sorted(expects)}")
                findings.append(Finding(
                    "kernel_presence", "violation", where,
                    f"routed via {ev.route!r}, expected {want} for "
                    f"impl={impl!r}"))
            if ev.route == "qdq_fallback":
                findings.append(Finding(
                    "kernel_presence", "fallback", where,
                    "pallas impl fell back to QDQ: "
                    + ("; ".join(ev.reasons) or "no reason recorded")))

    for i in range(n_layers):
        for cls in classes:
            mm = plan.layer(i).for_class(cls)
            need = roles if not mm.is_passthrough else ("fwd",)
            if packed:
                need = ("fwd",)
            for role in need:
                if (i, cls, role) not in seen:
                    findings.append(Finding(
                        "kernel_presence", "violation",
                        f"L{i}/{cls}/{role}",
                        "plan cell never ran — no routing event"))
    if not head_seen:
        findings.append(Finding("kernel_presence", "violation",
                                "head/fwd",
                                "lm-head matmul never ran"))
    return findings


def audit_graph_vs_census(graph: Dict[str, Any],
                          cells: Sequence[routing.RouteEvent]
                          ) -> List[Finding]:
    """Cross-check the markers against the routing census: every role
    with pallas-routed cells made at least as many kernel calls as it
    has distinct cells; every QDQ marker under a role is explained by a
    QDQ-routed census cell of that role (an unexplained one means a
    quantize reached a path the census never sanctioned); an operand
    wider than the compute dtype on a kernel call is a violation."""
    findings: List[Finding] = []
    pallas_cells = Counter()
    allowed_markers = set()
    for ev in cells:
        if ev.route == "pallas":
            pallas_cells[ev.role] += 1
        if ev.route in ("qdq", "qdq_fallback", "dot", "packed_dot"):
            for spec_str in (ev.spec_a, ev.spec_b):
                spec = QuantSpec.from_str(spec_str)
                if not spec.is_passthrough:
                    allowed_markers.add((ev.role, qdq_scope_name(spec)))

    calls = graph.get("pallas_calls", {})
    for role, n_cells in pallas_cells.items():
        n_calls = calls.get(role, 0)
        if n_calls < n_cells:
            findings.append(Finding(
                "kernel_presence", "violation", f"qrole_{role}",
                f"census routes {n_cells} cell(s) through pallas but the "
                f"step made only {n_calls} kernel call(s) under the role"))
    for role in calls:
        if role != "-" and role not in pallas_cells:
            findings.append(Finding(
                "kernel_presence", "violation", f"qrole_{role}",
                "kernel call under a role with no pallas-routed census "
                "cell"))

    for key, count in graph.get("qdq_markers", {}).items():
        role, marker = key.split("/", 1)
        if role == "-":
            continue  # a quantize outside matmul roles
        if (role, marker) not in allowed_markers:
            findings.append(Finding(
                "role_safety", "violation", f"qrole_{role}/{marker}",
                f"quantize op ({count}x) under qrole_{role} that no "
                "census cell sanctions — quantize fed into a protected "
                "path?"))

    for msg in graph.get("f32_kernel_operands", []):
        findings.append(Finding(
            "role_safety", "violation", msg.split(":")[0],
            "operand wider than the compute dtype reaches a kernel-routed "
            "matmul: " + msg))
    return findings


def audit_comms(records, *, expect_fp8: bool,
                compute_dtype: Optional[str] = None) -> Tuple[
        Dict[str, Any], List[Finding]]:
    """Gradient payload audit over a step's recorded collectives (the
    counterpart of the reference's ``audit_hlo_comms``).

    ``expect_fp8``: the step was built with ``grad_compression='fp8'``
    and a data axis > 1, so every gradient payload (an all-gather of
    codes, an all-reduce or reduce-scatter of gradients) must be 1-byte
    codes; a wider payload means the gradient bytes went uncompressed.
    The f32 amax reductions of the shared scales are scale metadata,
    censused apart and not flagged.  So are the quant groups' shared
    amax reductions of a data-parallel token split (tag ``amax``) and of
    a tensor-parallel model split (tag ``amax_model``): they are counted
    as words (one a quant group and rank), never as payloads; one over
    the data group that is not a MAX all-reduce of 4-byte words, or one
    over the model group that is neither that nor an all-gather of 4-byte
    words (a block / tile group's window), is a violation.  The
    tensor-parallel sums (``tp_fwd``: a row-parallel output, ``tp_bwd``:
    a column-parallel input's cotangent) are censused by layer, in
    bytes, and the split norms' statistics (``tp_norm``: one f32 word a
    row each way, a SUM all-reduce, or a violation) apart; so are the
    expert-parallel gathers (``ep_fwd``: a rank's
    expert outputs, ``ep_bwd``: its experts' input cotangents), counted
    apart: one that is not an all-gather, or (``compute_dtype`` given,
    e.g. ``"bfloat16"``) whose payload is not in the compute dtype, is a
    violation.  Returns (census, findings)."""
    findings: List[Finding] = []
    grad = [r for r in records if r.tag in _GRAD_TAGS]
    amax = [r for r in records if r.tag == "amax"]
    amax_model = [r for r in records if r.tag == "amax_model"]
    tp = [r for r in records if r.tag in ("tp_fwd", "tp_bwd")]
    norm = [r for r in records if r.tag == "tp_norm"]
    ep = [r for r in records if r.tag in ("ep_fwd", "ep_bwd")]

    def by_layer(recs):
        out: Dict[str, Dict[str, int]] = {}
        for r in recs:
            layers = out.setdefault(r.tag, {})
            layers[r.layer or "-"] = layers.get(r.layer or "-", 0) \
                + r.nbytes
        return out
    census = {"grad_payload_dtypes": dict(Counter(r.dtype for r in grad)),
              "scale_allreduce_dtypes": dict(Counter(
                  r.dtype for r in records if r.tag == "scale")),
              "amax_allreduces": len(amax),
              "amax_words": sum(math.prod(r.shape) for r in amax),
              "amax_model_ops": len(amax_model),
              "amax_model_words": sum(math.prod(r.shape)
                                      for r in amax_model),
              "tp_sums": len(tp),
              "tp_bytes_by_layer": by_layer(tp),
              "tp_norm_ops": len(norm),
              "tp_norm_bytes_by_layer": by_layer(norm).get("tp_norm", {}),
              "ep_ops": dict(Counter(r.tag for r in ep)),
              "ep_bytes_by_layer": by_layer(ep),
              "other": dict(Counter(f"{r.tag}:{r.op}:{r.dtype}"
                                    for r in records
                                    if r.tag not in _GRAD_TAGS
                                    + ("scale", "amax", "amax_model",
                                       "tp_fwd", "tp_bwd", "tp_norm",
                                       "ep_fwd", "ep_bwd"))),
              "grad_payload_bytes": sum(r.nbytes for r in grad),
              "bytes": collective_bytes(records)}
    for r in amax + amax_model:
        ok = {("all-reduce", "max")} | (
            {("all-gather", "")} if r.tag == "amax_model" else set())
        if (r.op, r.reduce_op) not in ok or \
                r.nbytes != 4 * math.prod(r.shape):
            findings.append(Finding(
                "comms", "violation", f"{r.op}[{r.tag}]",
                f"a shared amax travels as a MAX all-reduce (or, over the "
                f"model group, an all-gather) of 4-byte words, not "
                f"{r.op} {r.reduce_op} of {r.dtype}"))
    for r in tp:
        if (r.op, r.reduce_op) != ("all-reduce", "sum"):
            findings.append(Finding(
                "comms", "violation", f"{r.op}[{r.tag}]",
                f"a tensor-parallel sum travels as a SUM all-reduce, not "
                f"{r.op} {r.reduce_op}"))
    for r in norm:
        if (r.op, r.reduce_op, r.dtype) != ("all-reduce", "sum",
                                            "float32") or r.shape[-1:] != (1,):
            findings.append(Finding(
                "comms", "violation", f"{r.op}[{r.tag}]",
                f"a norm's split statistic travels as a SUM all-reduce of "
                f"one f32 word a row, not {r.op} {r.reduce_op} of "
                f"{r.dtype}{list(r.shape)}"))
    for r in ep:
        if r.op != "all-gather":
            findings.append(Finding(
                "comms", "violation", f"{r.op}[{r.tag}]",
                f"an expert-parallel exchange travels as an all-gather, "
                f"not {r.op} {r.reduce_op}"))
        elif compute_dtype is not None and r.dtype != compute_dtype:
            findings.append(Finding(
                "comms", "violation", f"{r.op}[{r.tag}]",
                f"an expert-parallel gather moves {r.dtype}, not the "
                f"compute dtype {compute_dtype}"))
    if expect_fp8:
        if not grad:
            findings.append(Finding(
                "comms", "violation", "grad",
                "fp8 gradient compression expected but the step issued "
                "no gradient payload"))
        for r in grad:
            if r.nbytes != math.prod(r.shape):
                findings.append(Finding(
                    "comms", "violation", f"{r.op}[{r.tag}]",
                    f"gradient payload is {r.dtype}{list(r.shape)}, not "
                    "1-byte fp8 codes"))
    return census, findings


def audit_scale_placement(plan: PrecisionPlan) -> List[Finding]:
    """The quant-scale placement policy against the resolved plan:
    block / tile scale grids must shard WITH their operand's reduction
    axis, token / tensor scales must replicate along it; checked for the
    granularities the plan uses."""
    findings = []
    grans = set()
    for i in range(plan.n_layers):
        for cls in ("attn", "ffn"):
            mm = plan.layer(i).for_class(cls)
            for role in _TRAIN_ROLES:
                for spec in _role_specs(mm, role):
                    if not spec.is_passthrough:
                        grans.add(spec.granularity)
    for gran in sorted(grans):
        for red_axis, red_name in ((1, "col"), (0, "row")):
            logical = scale_logical_axes(gran, red_axis, ("row", "col"))
            with_red = red_name in logical
            if gran in ("block", "tile") and not with_red:
                findings.append(Finding(
                    "comms", "violation", f"scale[{gran}]",
                    f"{gran} scales no longer shard with the reduction "
                    f"axis (axis {red_axis} -> {logical})"))
            if gran in ("token", "tensor") and with_red:
                findings.append(Finding(
                    "comms", "violation", f"scale[{gran}]",
                    f"{gran} scales must replicate along the reduction "
                    f"axis but got {logical}"))
    return findings


# ---------------------------------------------------------------------------
# Recompile budget
# ---------------------------------------------------------------------------

def _plan_fingerprint(plan) -> str:
    blob = json.dumps(plan.to_dict(), sort_keys=True).encode()
    return hashlib.md5(blob).hexdigest()[:10]


def recompile_census(trainer, extra_plans: Sequence[PrecisionPlan] = ()
                     ) -> Tuple[Dict[str, Any], List[Finding]]:
    """Key census over the trainer's step functions (``Trainer._steps``,
    keyed by (plan, telemetry) as the reference's compiled graphs).
    Expected plans: the stage-1 plan, the schedule's stage-2 target,
    every plan the controller has made, and ``extra_plans``; a key whose
    plan is outside that set, or more steps than |plans| x |telemetry
    variants|, is an unexpected rebuild."""
    findings: List[Finding] = []
    target = trainer.schedule.target_plan
    if callable(target):
        target = target()
    expected = {_plan_fingerprint(trainer.plan), _plan_fingerprint(target)}
    if trainer.controller is not None:
        cache = getattr(trainer.controller, "_plan_cache", {})
        expected |= {_plan_fingerprint(p) for p in cache.values()}
    expected |= {_plan_fingerprint(p) for p in extra_plans}
    observed = [(_plan_fingerprint(plan), tel)
                for (plan, tel) in trainer._steps]
    tel_variants = {tel for _, tel in observed}
    budget = len(expected) * max(1, len(tel_variants))
    for fp, tel in observed:
        if fp not in expected:
            findings.append(Finding(
                "recompile", "violation", f"step[{fp},tel={tel}]",
                "step function for a plan outside the expected set "
                "(unexpected rebuild)"))
    if len(observed) > budget:
        findings.append(Finding(
            "recompile", "violation", "steps",
            f"{len(observed)} step functions exceed the budget of "
            f"{budget} ({len(expected)} plan(s) x "
            f"{max(1, len(tel_variants))} telemetry variant(s))"))
    census = {"n_compiled": len(observed),
              "budget": budget,
              "keys": [f"{fp}:tel={tel}" for fp, tel in observed]}
    return census, findings


def engine_capture_census(engine) -> Tuple[Dict[str, Any], List[Finding]]:
    """The engine's CUDA-graph captures per stage (``GraphedStage``, the
    counterpart of the reference's jit cache) against its budget: one
    prefill graph per bucket, one insert and one decode-step graph.  An
    eager engine (``jit=False``, or CPU tensors) captures nothing."""
    findings: List[Finding] = []
    n_buckets = 1
    while engine.min_bucket * 2 ** (n_buckets - 1) < engine.max_len:
        n_buckets += 1
    budget = {"prefill": n_buckets, "insert": 1, "generate": 1}
    captures = {name: getattr(stage, "captures", 0)
                for name, stage in engine.stages.items()}
    for name, n in captures.items():
        if n > budget[name]:
            findings.append(Finding(
                "recompile", "violation", f"stage[{name}]",
                f"{n} captures exceed the budget of {budget[name]}"))
    return {"captures": captures, "budget": budget}, findings


# ---------------------------------------------------------------------------
# The audited steps
# ---------------------------------------------------------------------------

def _synth_batch(cfg, batch: int, seq: int, device) -> Dict[str, Any]:
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         dtype=torch.int32).to(device)
    return {"tokens": toks, "targets": toks}


def _profiled(run, trace: bool):
    """``run()`` under a ``torch.profiler`` trace of the card when
    ``trace``; returns the profile (None without)."""
    if not trace:
        run()
        return None
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a trace can lose its first events in a long process: let the
        # session take in some of its own first
        warm = torch.zeros(1, device="cuda")
        for _ in range(64):
            warm.add_(1)
        torch.cuda.synchronize()
        run()
        torch.cuda.synchronize()
    return prof


def _finish_report(report: QlintReport, log: routing.RoutingLog, cfg,
                   run_plan: PrecisionPlan, plan: PrecisionPlan, impl: str,
                   *, roles=_TRAIN_ROLES, packed=False,
                   prof=None) -> QlintReport:
    cells = _cells(log, cfg, run_plan)
    graph = graph_census(log, cfg.dtype)
    report.cells = [ev.to_dict() for ev in cells]
    report.extend(audit_cells(cells, plan, impl, roles=roles,
                              packed=packed))
    report.extend(audit_graph_vs_census(graph, cells))
    report.extend(audit_scale_placement(plan))
    report.summary = {
        "n_cells": len(cells),
        "n_fallback_cells": sum(ev.route == "qdq_fallback"
                                for ev in cells),
        "pallas_calls": graph["pallas_calls"],
        "qdq_markers": graph["qdq_markers"],
        "n_kernel_calls": graph["n_kernel_calls"],
        "kernels": dict(Counter(c.name for c in log.kernel_calls)),
    }
    if prof is not None:
        role_ops, missed, left = trace_role_ops(prof, log.kernel_calls)
        report.summary["trace_role_ops"] = role_ops
        report.summary["trace_calls_not_found"] = missed
        report.summary["trace_kernels_left_over"] = left
        if missed or left:
            report.add(Finding(
                "kernel_presence", "info", "trace",
                f"{missed} kernel call(s) not found in the profiler trace, "
                f"{left} port kernel(s) in it matched to no call"))
        for role in sorted({ev.role for ev in cells if ev.route == "pallas"}
                           - set(role_ops)):
            report.add(Finding(
                "kernel_presence", "violation", f"trace/qrole_{role}",
                "no CUDA kernel of the role in the profiler trace"))
    return report


def _audit_step(trainer, plan: Optional[PrecisionPlan], label: str,
                batch: int, seq: int, trace: Optional[bool]
                ) -> QlintReport:
    """One forward and backward of the trainer's plan on a fresh init
    (no optimizer step), audited against ``plan`` (default the
    trainer's).  On a data-parallel mesh the whole step runs (its
    collectives are the audit's subject) on a fresh state, and
    ``audit_comms`` reads what it issued."""
    from repro_torch.distributed import comms
    from repro_torch.train.train_step import _grads
    model, tcfg = trainer.model, trainer.tcfg
    cfg = model.cfg
    trace = model.device.type == "cuda" if trace is None else trace
    step = trainer._step_fn(trainer.plan)   # the step the census counts
    b = _synth_batch(cfg, batch, seq, model.device)
    report = QlintReport(label)
    if trainer.dp is None:
        params = model.init(tcfg.seed)
        run = lambda: _grads(model, trainer.plan, params, b)  # noqa: E731
    else:
        st = trainer.init_state()
        run = lambda: step(st.params, st.opt_state,  # noqa: E731
                           st.comp_state, b, 0)
    with routing.capture(markers=True) as log, comms.recording() as rec:
        prof = _profiled(run, trace)
    del run
    _finish_report(report, log, cfg, trainer.plan,
                   plan if plan is not None else trainer.plan,
                   cfg.linear_impl, prof=prof)
    if trainer.dp is not None:
        comms_census, findings = audit_comms(
            rec, expect_fp8=trainer._spmd, compute_dtype=cfg.dtype)
        report.summary["comms"] = comms_census
        report.extend(findings)
    census, findings = recompile_census(trainer)
    report.summary["recompile"] = census
    report.extend(findings)
    return report


def audit_train_graph(cfg, tcfg, *, label: str = "train",
                      batch: Optional[int] = None,
                      seq: Optional[int] = None,
                      plan: Optional[PrecisionPlan] = None,
                      device=None, trace: Optional[bool] = None
                      ) -> QlintReport:
    """Run one training step's forward and backward (no optimizer step)
    of a fresh ``Trainer`` on ``device`` and audit it.  ``plan``
    overrides the trainer's plan as the AUDIT REFERENCE only — the step
    still runs the trainer's plan: the seeded-violation hook (run plan B,
    audit against plan A).  ``trace`` (default: on CUDA) adds the
    profiler trace's kernels per role.  With ``tcfg.mesh_shape`` every
    rank of the world runs this (see ``_audit_step``)."""
    from repro_torch.models import build_model
    from repro_torch.train.trainer import Trainer
    trainer = Trainer(build_model(cfg, device), tcfg, pipeline=None)
    return _audit_step(trainer, plan, label, batch or tcfg.global_batch,
                       seq or tcfg.seq_len, trace)


def audit_decode_graph(cfg, recipe, *, label: str = "decode",
                       n_slots: int = 2, max_len: int = 64,
                       kv_format: Optional[str] = "fp8_e4m3",
                       fmt: str = "fp4_e2m1", device=None,
                       trace: Optional[bool] = None) -> QlintReport:
    """Build a packed-weight :class:`DecodeEngine` on ``device`` and audit
    one batched decode step (quantize-once panels -> ``packed_dot`` /
    fused activation-quant routes; forward role only)."""
    from repro_torch.models import build_model
    from repro_torch.train.serving_runtime import (
        DecodeEngine, quantize_weights_for_serving)
    model = build_model(cfg, device)
    qparams = quantize_weights_for_serving(model, model.init(0), fmt,
                                           packed=True, device=model.device)
    engine = DecodeEngine(model, qparams, n_slots=n_slots, max_len=max_len,
                          recipe=recipe, kv_format=kv_format, jit=True,
                          device=model.device)
    return audit_decode_engine(engine, label=label, trace=trace)


def audit_decode_engine(engine, *, label: str = "decode",
                        trace: Optional[bool] = None) -> QlintReport:
    """Audit one batched decode step of an existing engine (its
    ``qlint_report`` hook), run eagerly on a scratch copy of its cache:
    the engine's cache, slots and last logits stay as they were.
    Forward only: serving has no backward matmuls."""
    from repro_torch.core.packed import PackedTensor
    from repro_torch.tree import tree_leaves, tree_map
    cfg = engine.model.cfg
    plan = PrecisionPlan.uniform(engine.recipe, cfg.n_layers)
    trace = engine.device.type == "cuda" if trace is None else trace
    cache = tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                     else t, engine.cache)
    toks = torch.zeros((engine.n_slots, 1), dtype=torch.int64,
                       device=engine.device)
    live = torch.zeros((engine.n_slots,), dtype=torch.bool,
                       device=engine.device)
    packed = any(isinstance(p, PackedTensor)
                 for p in tree_leaves(engine.params))
    report = QlintReport(label)
    with torch.no_grad(), routing.capture(markers=True) as log:
        prof = _profiled(
            lambda: engine._generate_impl(engine.params, cache, toks, live),
            trace)
    _finish_report(report, log, cfg, plan, plan, cfg.linear_impl,
                   roles=("fwd",), packed=packed, prof=prof)
    census, findings = engine_capture_census(engine)
    report.summary["recompile"] = census
    report.extend(findings)
    return report


def audit_trainer(trainer, *, label: str = "trainer",
                  trace: bool = False) -> QlintReport:
    """The :meth:`Trainer.qlint_report` backend: audit the trainer's plan's
    step (forward and backward on a fresh init at the config's batch; no
    optimizer step, the trainer's state untouched) plus the
    recompile-budget census over every step function it has built.  On
    a mesh every rank calls it (the step's collectives)."""
    return _audit_step(trainer, None, label, trainer.tcfg.global_batch,
                       trainer.tcfg.seq_len, trace)


# ---------------------------------------------------------------------------
# Expectations (the gate)
# ---------------------------------------------------------------------------

def expectations_payload(reports: Sequence[QlintReport]) -> Dict[str, Any]:
    """The normalized, diff-stable subset committed as the gate: the
    deduped cell census plus marker counts per step, and the global
    violation/fallback totals (which the gate requires to be zero)."""
    out: Dict[str, Any] = {"version": 1, "graphs": {}}
    for r in reports:
        cells = sorted(
            ({k: v for k, v in c.items()} for c in r.cells),
            key=lambda c: (c["layer"] or "", c["cls"] or "", c["role"],
                           c["route"]))
        out["graphs"][r.label] = {
            "cells": cells,
            "pallas_calls": r.summary.get("pallas_calls", {}),
            "qdq_markers": r.summary.get("qdq_markers", {}),
            "n_violations": len(r.violations()),
            "n_fallbacks": len(r.fallbacks()),
        }
    out["n_violations"] = sum(len(r.violations()) for r in reports)
    out["n_fallbacks"] = sum(len(r.fallbacks()) for r in reports)
    return out


def compare_expectations(payload: Dict[str, Any],
                         expected: Dict[str, Any]) -> List[str]:
    """Differences between the current audit and the committed
    expectations, as human-readable strings (empty = gate passes)."""
    diffs: List[str] = []
    for key in ("n_violations", "n_fallbacks"):
        if payload.get(key) != expected.get(key):
            diffs.append(f"{key}: expected {expected.get(key)}, got "
                         f"{payload.get(key)}")
    exp_graphs = expected.get("graphs", {})
    got_graphs = payload.get("graphs", {})
    for label in sorted(set(exp_graphs) | set(got_graphs)):
        if label not in got_graphs:
            diffs.append(f"graph {label!r}: missing from this audit")
            continue
        if label not in exp_graphs:
            diffs.append(f"graph {label!r}: not in the expectations file "
                         "(run --update-expectations)")
            continue
        e, g = exp_graphs[label], got_graphs[label]
        for key in ("cells", "pallas_calls", "qdq_markers",
                    "n_violations", "n_fallbacks"):
            if e.get(key) != g.get(key):
                diffs.append(f"graph {label!r}: {key} drifted\n"
                             f"    expected: {json.dumps(e.get(key))[:400]}\n"
                             f"    got:      {json.dumps(g.get(key))[:400]}")
    return diffs


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _parse_mesh(s: Optional[str]) -> Optional[Tuple[int, ...]]:
    if not s:
        return None
    return tuple(int(p) for p in s.split(","))


def build_reports(config: str, plan_name: str, *, impl: str = "pallas",
                  mesh: Optional[Tuple[int, ...]] = None,
                  decode: bool = False, seq: int = 32, batch: int = 4,
                  device=None, trace: Optional[bool] = None
                  ) -> List[QlintReport]:
    """The CLI's step family: unrolled and scan-layout train steps,
    with ``mesh`` a data-sharded step with fp8 gradient comms (every rank
    of a world of ``prod(mesh)`` calls this), and with ``decode`` the
    packed decode step."""
    import torch.distributed as dist
    from repro_torch.configs.base import TrainConfig, get_config
    from repro_torch.core.recipe import RECIPES

    if mesh is not None:
        need = math.prod(mesh)
        have = dist.get_world_size() if dist.is_initialized() else 1
        if have < need:
            raise SystemExit(
                f"--mesh {mesh} needs {need} ranks but the world has "
                f"{have}; launch them with torchrun --standalone "
                f"--nproc-per-node {need} -m repro_torch.analysis.qlint "
                "... (gloo on --device cpu, NCCL on cuda)")
    base = get_config(config).replace(linear_impl=impl)
    tcfg = TrainConfig(recipe=plan_name, total_steps=8, global_batch=batch,
                       seq_len=seq)
    reports = [
        audit_train_graph(base.replace(scan_layers=False), tcfg,
                          label="train_unroll", device=device, trace=trace),
        audit_train_graph(base.replace(scan_layers=True), tcfg,
                          label="train_scan", device=device, trace=trace),
    ]
    if mesh is not None:
        dp = mesh[0]
        tcfg_m = dataclasses.replace(
            tcfg, mesh_shape=mesh, fsdp=False,
            grad_compression="fp8" if dp > 1 else "none")
        reports.append(audit_train_graph(
            base.replace(scan_layers=True), tcfg_m,
            label=f"train_mesh{'x'.join(map(str, mesh))}", device=device,
            trace=trace))
    if decode:
        reports.append(audit_decode_graph(
            base, RECIPES[plan_name], label="decode_packed", device=device,
            trace=trace))
    return reports


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.qlint",
        description="Precision-flow audit of the port's train and decode "
                    "steps")
    ap.add_argument("--config", default="tiny")
    ap.add_argument("--plan", default="fine_grained_fp4",
                    help="recipe name (core.recipe.RECIPES)")
    ap.add_argument("--impl", default="pallas",
                    choices=["qdq", "pallas", "pallas_two_pass"])
    ap.add_argument("--mesh", default=None,
                    help="comma mesh shape, e.g. 2,1 (data,model); adds a "
                         "sharded train step with fp8 gradient comms (run "
                         "its ranks under torchrun)")
    ap.add_argument("--decode", action="store_true",
                    help="also audit the packed-weight decode step")
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda | cpu")
    ap.add_argument("--json", default=None,
                    help="write the full findings JSON here")
    ap.add_argument("--expect", default=None,
                    help="expectations JSON to gate against")
    ap.add_argument("--update-expectations", action="store_true",
                    help="rewrite --expect from this audit instead of "
                         "gating")
    args = ap.parse_args(argv)
    mesh = _parse_mesh(args.mesh)
    if mesh is not None:
        from repro_torch.distributed.mesh import init_distributed
        init_distributed(args.device)

    reports = build_reports(args.config, args.plan, impl=args.impl,
                            mesh=mesh, decode=args.decode,
                            seq=args.seq, batch=args.batch,
                            device=args.device)
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_rank() != 0:
        n_viol = sum(len(r.violations()) for r in reports)
        return 1 if n_viol else 0

    for r in reports:
        print(r.human_report())
        print()

    n_viol = sum(len(r.violations()) for r in reports)
    n_fall = sum(len(r.fallbacks()) for r in reports)
    print(f"qlint: {len(reports)} graph(s), {n_viol} violation(s), "
          f"{n_fall} fallback(s)")

    if args.json:
        with open(args.json, "w") as f:
            json.dump({"reports": [r.to_dict() for r in reports]}, f,
                      indent=1, sort_keys=True)
        print(f"qlint: findings JSON -> {args.json}")

    payload = expectations_payload(reports)
    if args.expect:
        if args.update_expectations:
            with open(args.expect, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
                f.write("\n")
            print(f"qlint: expectations updated -> {args.expect}")
        else:
            with open(args.expect) as f:
                expected = json.load(f)
            diffs = compare_expectations(payload, expected)
            for d in diffs:
                print(f"qlint: EXPECTATION DRIFT: {d}")
            if diffs:
                return 2
            print("qlint: expectations match")
    return 1 if n_viol else 0


if __name__ == "__main__":
    sys.exit(main())
