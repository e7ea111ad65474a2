"""Routing census and the layer / plan-class scopes (counterpart of
``repro.core.routing``).

Every matmul role of the model goes through one of a small set of
routes: the fused kernels (``pallas``, the reference's name for them;
here the CUDA kernels), the QDQ simulation (``qdq``), a QDQ fallback from
a fused impl that cannot realize a spec (``qdq_fallback``), a plain
matmul for a
passthrough recipe (``dot``) and the serving panel matmul
(``packed_dot``).  ``capture()`` installs a :class:`RoutingLog`; while it
is active, ``core.qlinear`` and ``kernels.ops`` append one
:class:`RouteEvent` per matmul-role routing decision, tagged with the
layer label (``"L3"``: the port loops over layers, so labels are always
the reference's unrolled form) and the plan class.

``models.stack`` opens a ``layer_scope`` per layer and
``telemetry.collect.module_scope`` a ``class_scope`` per sublayer, so
code inside can ask which (layer, plan class) it runs for.  The scopes
and the log are thread-local, and a CUDA backward runs on autograd's own
thread: ``qlinear``'s autograd Function keeps the log and the cell of its
forward (``active`` / ``current_cell``) and records its backward roles
into that log (``record(..., log=...)``), as the reference threads the
cell through its custom VJP.  A rematerialized forward re-installs the
log of the original forward (``replaying``).  Raw event counts repeat
(the recompute records again); consumers dedupe by
:meth:`RouteEvent.cell`, which :meth:`RoutingLog.cells` does.

An inactive census costs one ``is None`` check per matmul and never
touches a tensor.

Markers (``capture(markers=True)``, what ``analysis.qlint`` installs):
the counterpart of the reference's ``qrole_*`` / ``qdq_*`` named scopes
and of its jaxpr's ``pallas_call`` equations.  The reference proves what
was *staged* apart from what the census *decided*; the port records what
*ran*.  ``core.qlinear`` opens a ``role_scope`` (fwd | dgrad | wgrad)
around each matmul role it sends to the kernels or to QDQ; inside a
marking capture every kernel call (``kernels.build.CudaKernel.launch``,
or a wrapper's CPU branch) appends a :class:`KernelCall` (kernel name,
the role in scope, operand dtypes and shapes, the kernels it launched)
and every QDQ of the ``qdq`` routes one ``(role,
qdq_scope_name(spec))`` pair; ``analysis.trace.trace_role_ops`` matches
the calls, in launch order, to the CUDA kernels of a profiler trace.
Outside a marking capture a kernel call costs one function call and one
attribute check, a role scope one check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["RouteEvent", "RoutingLog", "KernelCall", "capture", "active",
           "record", "replaying", "layer_scope", "class_scope",
           "plan_class_for_module", "current_layer", "current_class",
           "current_cell", "marking", "role_scope", "current_role",
           "mark_kernel", "mark_qdq"]

# Telemetry module scopes -> plan class: attention and cross-attention use
# the plan's attn_linear cell, ssm / ffn / moe its ffn_linear, the LM head
# its head_linear.
_MODULE_TO_CLASS = {"attn": "attn", "cross": "attn",
                    "ssm": "ffn", "ffn": "ffn", "moe": "ffn",
                    "head": "head"}

_STATE = threading.local()


def plan_class_for_module(module: str) -> Optional[str]:
    """Map a telemetry module-scope name to its PrecisionPlan class."""
    return _MODULE_TO_CLASS.get(module)


@dataclasses.dataclass(frozen=True)
class RouteEvent:
    """One matmul-role routing decision.

    ``layer`` is ``"L<i>"`` (None outside the stack, e.g. the lm-head),
    ``cls`` the plan class, ``role`` fwd | dgrad | wgrad.  ``route``:
    ``pallas`` (the fused kernels; ``mode_a`` / ``mode_b`` / ``pipeline``
    say how each operand is quantized in-kernel), ``qdq``,
    ``qdq_fallback`` (``reasons``: one structured string per
    unrealizable operand), ``dot`` or ``packed_dot``.  ``sr_a`` /
    ``sr_b``: stochastic rounding actually armed for that operand (the
    spec says ``:sr`` and key material reached the call).
    """
    layer: Optional[str]
    cls: Optional[str]
    role: str                      # fwd | dgrad | wgrad
    route: str
    spec_a: str
    spec_b: str
    mode_a: Optional[str] = None
    mode_b: Optional[str] = None
    pipeline: Optional[str] = None
    sr_a: bool = False
    sr_b: bool = False
    reasons: Tuple[str, ...] = ()

    def cell(self) -> Tuple:
        """Dedupe identity: independent of call order and repeats."""
        return (self.layer, self.cls, self.role, self.route,
                self.spec_a, self.spec_b, self.mode_a, self.mode_b,
                self.pipeline, self.sr_a, self.sr_b, self.reasons)

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["reasons"] = list(self.reasons)
        return d


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One call of a kernel wrapper inside a marking capture: the kernel
    (``CudaKernel.name``), the matmul role in scope (None outside one:
    flash attention), the layer label in scope, each operand's (dtype,
    shape), the device type it ran on and the kernels it launched there
    (0 when its plain version ran)."""
    name: str
    role: Optional[str]
    layer: Optional[str]
    operands: Tuple[Tuple[str, Tuple[int, ...]], ...]
    device: str
    launches: int = 0


class RoutingLog:
    """Accumulates :class:`RouteEvent`s for one captured run; with
    ``markers`` also the :class:`KernelCall`s (``kernel_calls``) and the
    ``(role, qdq scope name)`` of every QDQ (``qdq_calls``)."""

    def __init__(self, markers: bool = False) -> None:
        self.events: List[RouteEvent] = []
        self.kernel_calls: Optional[List[KernelCall]] = (
            [] if markers else None)
        self.qdq_calls: Optional[List[Tuple[Optional[str], str]]] = (
            [] if markers else None)

    def add(self, ev: RouteEvent) -> None:
        self.events.append(ev)

    def cells(self) -> List[RouteEvent]:
        """Events deduped by :meth:`RouteEvent.cell`, in first-seen order:
        the stable census (a recompute re-emits identical events)."""
        seen = {}
        for ev in self.events:
            seen.setdefault(ev.cell(), ev)
        return list(seen.values())

    def fallbacks(self) -> List[RouteEvent]:
        return [ev for ev in self.cells() if ev.route == "qdq_fallback"]

    def to_dict(self) -> Dict:
        return {"cells": [ev.to_dict() for ev in self.cells()],
                "n_raw_events": len(self.events)}


def active() -> Optional[RoutingLog]:
    """The installed RoutingLog of this thread, or None (the common
    case)."""
    return getattr(_STATE, "log", None)


def current_layer() -> Optional[str]:
    return getattr(_STATE, "layer", None)


def current_class() -> Optional[str]:
    return getattr(_STATE, "cls", None)


def current_cell() -> Optional[Tuple[Optional[str], Optional[str]]]:
    """The (layer, class) attribution here, or None when no census is
    running.  Captured by ``qlinear`` in the forward, in scope, for the
    events its backward records."""
    if active() is None:
        return None
    return (current_layer(), current_class())


@contextlib.contextmanager
def _scoped(attr: str, value):
    prev = getattr(_STATE, attr, None)
    setattr(_STATE, attr, value)
    try:
        yield
    finally:
        setattr(_STATE, attr, prev)


@contextlib.contextmanager
def capture(markers: bool = False):
    """Install a fresh RoutingLog (yielded) for the code inside; with
    ``markers`` it also records kernel calls and QDQs (module
    docstring)."""
    log = RoutingLog(markers)
    with _scoped("log", log):
        yield log


def marking() -> bool:
    """Whether a marking capture is installed on this thread."""
    log = getattr(_STATE, "log", None)
    return log is not None and log.kernel_calls is not None


def current_role() -> Optional[str]:
    return getattr(_STATE, "role", None)


def role_scope(role: Optional[str]):
    """The matmul role (fwd | dgrad | wgrad) for the kernel calls and QDQs
    inside; a no-op outside a marking capture."""
    if role is None or not marking():
        return contextlib.nullcontext()
    return _scoped("role", role)


def mark_kernel(name: str, operands, launches: int = 0) -> None:
    """Record one kernel call on ``operands`` (tensors) that launched
    ``launches`` kernels on the card (0: the plain version ran), in a
    marking capture; nothing otherwise."""
    log = getattr(_STATE, "log", None)
    if log is None or log.kernel_calls is None:
        return
    log.kernel_calls.append(KernelCall(
        name, current_role(), current_layer(),
        tuple((str(t.dtype).replace("torch.", ""), tuple(t.shape))
              for t in operands),
        operands[0].device.type if operands else "?", launches))


def mark_qdq(scope: str) -> None:
    """Record one QDQ (its ``qdq_scope_name``) under the role in scope, in
    a marking capture; nothing otherwise."""
    log = getattr(_STATE, "log", None)
    if log is not None and log.qdq_calls is not None:
        log.qdq_calls.append((current_role(), scope))


def replaying(log: Optional[RoutingLog]):
    """Re-install ``log`` (``active()`` of an original forward) for its
    rematerialization, which autograd may run on another thread."""
    if log is None:
        return contextlib.nullcontext()
    return _scoped("log", log)


def layer_scope(label: Optional[str]):
    """Static layer label (``"L3"``) for the code inside."""
    if label is None:
        return contextlib.nullcontext()
    return _scoped("layer", label)


def class_scope(module: str):
    """Plan-class attribution from a telemetry module scope name."""
    return _scoped("cls", plan_class_for_module(module) or current_class())


def record(role: str, route: str, spec_a, spec_b, *,
           mode_a: Optional[str] = None, mode_b: Optional[str] = None,
           pipeline: Optional[str] = None,
           sr_a: bool = False, sr_b: bool = False,
           reasons: Tuple[str, ...] = (),
           cell: Optional[Tuple[Optional[str], Optional[str]]] = None,
           log: Optional[RoutingLog] = None) -> None:
    """Append a routing decision to ``log`` (default: this thread's
    installed log; no-op when there is none).  ``cell`` overrides the
    ambient (layer, class) attribution: required for events of a
    backward, which runs out of the forward's scopes."""
    log = log if log is not None else active()
    if log is None:
        return
    layer, cls = cell if cell is not None else (current_layer(),
                                                current_class())
    log.add(RouteEvent(
        layer=layer, cls=cls, role=role, route=route,
        spec_a=str(spec_a), spec_b=str(spec_b), mode_a=mode_a, mode_b=mode_b,
        pipeline=pipeline, sr_a=sr_a, sr_b=sr_b, reasons=tuple(reasons)))
