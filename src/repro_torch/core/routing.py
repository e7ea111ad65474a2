"""Layer and plan-class attribution scopes (the scope stack of
``repro.core.routing``).

``models.stack`` opens a ``layer_scope`` per layer and
``telemetry.collect.module_scope`` a ``class_scope`` per sublayer, so
code inside can ask which (layer, plan class) it runs for
(``current_cell``).  The reference's route census on top of these scopes
(``RoutingLog``, ``capture``, ``record``) belongs to the qlint auditor and
is not ported yet.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Tuple

__all__ = ["layer_scope", "class_scope", "plan_class_for_module",
           "current_layer", "current_class", "current_cell"]

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


def current_layer() -> Optional[str]:
    return getattr(_STATE, "layer", None)


def current_class() -> Optional[str]:
    return getattr(_STATE, "cls", None)


def current_cell() -> Tuple[Optional[str], Optional[str]]:
    """The (layer label, plan class) at this point of the forward."""
    return (current_layer(), current_class())


@contextlib.contextmanager
def _scoped(attr: str, value):
    prev = getattr(_STATE, attr, None)
    setattr(_STATE, attr, value)
    try:
        yield
    finally:
        setattr(_STATE, attr, prev)


def layer_scope(label: Optional[str]):
    """Static layer label (``"L3"``) for the code inside."""
    if label is None:
        return contextlib.nullcontext()
    return _scoped("layer", label)


def class_scope(module: str):
    """Plan-class attribution from a telemetry module scope name."""
    return _scoped("cls", plan_class_for_module(module) or current_class())
